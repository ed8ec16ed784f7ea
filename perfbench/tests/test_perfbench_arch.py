"""Architecture plug-ins (`perfbench/architectures/`, `lib/arch.py`).

The `yoloclip` plug-in must give, bit for bit, what the harness computed
when it built `YOLOCLIPReference` by name: the `_direct_*` functions below
are those computations as they were written then (the variant's default
widths for the shapes and the FLOPs, the DFL box prior on the box towers'
last biases, the calibration through a reference built by name, the
eleven `ModelConfig` keys). A toy architecture defined here, registered
under a name of its own, shows that a configuration's own widths reach
the shapes, the weights, the reference, the FLOPs and the system with no
edit to any harness file."""

import math
import sys
from types import ModuleType

import pytest
import torch

from perfbench import run as bench
from perfbench.architectures import yoloclip
from perfbench.lib import arch, roofline, system, weights
from perfbench.reference.model import (YOLOCLIPReference, fp32_strict,
                                       state_shapes)

from . import small

torch.set_num_threads(4)

CELLS = {'yoloclip-n': 'n-coco80-batch32',
         'yoloclip-l': 'l-lvis1203-batch32-720p'}


def _direct_kind(key, shape):
    if key.endswith('num_batches_tracked'):
        return 'zero_long'
    if '.bn.' in key:
        return 'one' if key.endswith(('weight', 'running_var')) else 'zero'
    if key.endswith('in_proj_weight'):
        return 'xavier'
    if key.endswith('weight') and len(shape) >= 2:
        return 'lecun'
    return 'zero'


def _direct_state_dict(variant, seed, reg_max=16):
    shapes = state_shapes(variant)
    g = weights.generator(seed, 'cpu')
    out = {}
    for draw in ('lecun', 'xavier'):
        keys = [(k, s) for k, s in shapes.items()
                if _direct_kind(k, s) == draw]
        flat = torch.empty(sum(math.prod(s) for _, s in keys))
        if draw == 'lecun':
            flat.normal_(generator=g)
        else:
            flat.uniform_(-1, 1, generator=g)
        at = 0
        for k, s in keys:
            n = math.prod(s)
            w = flat[at:at + n].view(s)
            at += n
            w.mul_(1.0 / math.sqrt(n // s[0]) if draw == 'lecun'
                   else math.sqrt(6.0 / (s[0] + s[1])))
            out[k] = w
    for k, s in shapes.items():
        kind = _direct_kind(k, s)
        if kind == 'one':
            out[k] = torch.full(s, weights.BN_GAIN if k.endswith('.bn.weight')
                                else 1.0)
        elif kind == 'zero':
            out[k] = torch.zeros(s)
        elif kind == 'zero_long':
            out[k] = torch.zeros(s, dtype=torch.int64)
    prior = -torch.arange(reg_max + 1, dtype=torch.float32).repeat(4)
    for k in shapes:
        if k.startswith('box_head.box_convs.') and k.endswith('.2.bias'):
            out[k] = prior.clone()
    return out


def _direct_reference(cfg):
    return YOLOCLIPReference(cfg['backbone_variant'], cfg['embed_dim'],
                             cfg['hidden_dim'], cfg['reg_max'],
                             cfg['neck_bottlenecks'], cfg['strides'])


def _direct_calibrate(sd, cfg, text, seed):
    model = _direct_reference(cfg)
    model.load_state_dict(sd)
    model.train()
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.momentum = None
            m.reset_running_stats()
    g = weights.generator(seed ^ 0xCA11B, 'cpu')
    h, w = cfg['image_size']
    x = torch.rand((len(weights.FILLED_ROWS), 3, h, w), generator=g)
    for i, share in enumerate(weights.FILLED_ROWS):
        x[i, :, int(h * share):] = 0
    with torch.no_grad(), fp32_strict():
        model(x, text)
    out = dict(sd)
    for k, v in model.state_dict().items():
        if '.bn.running_' in k:
            out[k] = v.detach()
    return out


def _direct_flops(variant, classes, hw):
    from torch.utils.flop_counter import FlopCounterMode
    with torch.device('meta'):
        m = YOLOCLIPReference(variant)
        x = torch.empty((1, 3) + tuple(hw))
        t = torch.empty((classes, 512))
    with FlopCounterMode(display=False) as fc:
        m(x, t)
    return float(fc.get_total_flops())


def _same(a, b):
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


@pytest.fixture(scope='module', params=sorted(CELLS))
def made(request):
    """A small cell's configuration and its weights, the plug-in's and the
    direct ones, uncalibrated and calibrated."""
    cfg = small.spec(CELLS[request.param])['cfg']
    assert 'architecture' not in cfg
    _, text = weights.vocabulary(5, cfg['embed_dim'], 9, 'cpu')
    plug = arch.load(cfg).seeded_state_dict(cfg, 9, 'cpu')
    direct = _direct_state_dict(cfg['backbone_variant'], 9, cfg['reg_max'])
    return dict(cfg=cfg, text=text, plug=plug, direct=direct,
                plug_cal=weights.calibrate_batchnorm(plug, cfg, text, 9,
                                                     'cpu'),
                direct_cal=_direct_calibrate(direct, cfg, text, 9))


def test_seeded_weights_are_the_direct_ones(made):
    assert arch.load(made['cfg']) is yoloclip
    shapes = yoloclip.state_shapes(made['cfg'])
    assert shapes == state_shapes(made['cfg']['backbone_variant'])
    assert {k: tuple(v.shape) for k, v in made['plug'].items()} == shapes
    _same(made['plug'], made['direct'])


def test_calibration_and_reference_are_the_direct_ones(made):
    cfg = made['cfg']
    _same(made['plug_cal'], made['direct_cal'])
    canvas = torch.rand((2, 3) + tuple(cfg['image_size']),
                        generator=torch.Generator().manual_seed(3))
    outs = []
    for m in (yoloclip.reference(cfg), _direct_reference(cfg)):
        m.load_state_dict(made['direct_cal'])
        with torch.no_grad(), fp32_strict():
            outs.append(m.eval()(canvas, made['text']))
    for got, want in zip(*outs):
        assert torch.equal(got, want)


@pytest.mark.parametrize('config', sorted(CELLS))
@pytest.mark.parametrize('hw', [(640, 640), (128, 128)])
def test_flops_are_the_direct_count(config, hw):
    cfg = bench.load_json('perfbench', 'configs', config + '.json')
    want = _direct_flops(cfg['backbone_variant'], 1203, hw)
    assert roofline.model_flops_per_image(cfg, 1203, hw) == want
    assert roofline.model_flops_per_image(cfg['backbone_variant'], 1203,
                                          hw) == want


@pytest.mark.parametrize('workload', sorted(CELLS.values()))
def test_detector_config_is_the_direct_one(workload):
    from yoloclip_tpu_torch.config import InferenceConfig, ModelConfig
    cfg = bench.cell_spec(workload)['cfg']
    want = InferenceConfig(
        model=ModelConfig(
            backbone_variant=cfg['backbone_variant'],
            clip_model=cfg['clip_model'], embed_dim=cfg['embed_dim'],
            reg_max=cfg['reg_max'], strides=tuple(cfg['strides']),
            hidden_dim=cfg['hidden_dim'],
            neck_bottlenecks=cfg['neck_bottlenecks'],
            cls_alpha=cfg['cls_alpha'], cls_beta=cfg['cls_beta'],
            image_size=tuple(cfg['image_size']), dtype=cfg['dtype']),
        conf_threshold=cfg['conf_threshold'],
        iou_threshold=cfg['iou_threshold'], nms_topk=cfg['nms_topk'],
        max_detections=cfg['max_detections'],
        class_agnostic_nms=cfg['class_agnostic_nms'])
    assert system.inference_config(cfg) == want


def test_an_unknown_architecture_raises():
    with pytest.raises(ValueError, match="'yoloclip'"):
        arch.load({'architecture': 'no-such-model'})


def _toy(name, calls, **extra):
    """A plug-in that delegates to `yoloclip`, recording each call."""
    mod = ModuleType(f'{arch.PACKAGE}.{name}')

    def wrap(fn):
        def call(*args, **kw):
            calls.append(fn.__name__)
            return fn(*args, **kw)
        return call
    for fn in (yoloclip.reference, yoloclip.state_shapes,
               yoloclip.seeded_state_dict, yoloclip.flops_per_image,
               yoloclip.control):
        setattr(mod, fn.__name__, wrap(fn))
    mod.model_fields = yoloclip.model_fields
    for k, v in extra.items():
        setattr(mod, k, v)
    return mod


def test_a_model_field_the_system_lacks_raises(monkeypatch):
    monkeypatch.setitem(sys.modules, f'{arch.PACKAGE}.toy_fields', _toy(
        'toy_fields', [], model_fields=('backbone_variant', 'head_kind')))
    cfg = dict(small.spec('n-coco80-batch32')['cfg'],
               architecture='toy_fields')
    with pytest.raises(ValueError, match='head_kind'):
        system.detector(cfg, {}, 'unused.json', 'cpu')


def test_a_new_architecture_needs_no_harness_edit(monkeypatch):
    """A configuration of the toy architecture at embed_dim 256 runs a
    whole small cell, traced, to a correct result; its widths reach the
    seeded shapes, the reference, the FLOPs and the system."""
    calls = []
    monkeypatch.setitem(sys.modules, f'{arch.PACKAGE}.toy256',
                        _toy('toy256', calls))
    spec = small.spec('n-coco80-batch32')
    spec['cfg'].update(architecture='toy256', embed_dim=256)
    cfg = spec['cfg']
    assert arch.load(cfg).__name__.endswith('.toy256')

    shapes = arch.load(cfg).state_shapes(cfg)
    assert shapes['contrastive_heads.0.obj_embed_conv.2.weight'][0] == 256
    assert shapes != yoloclip.state_shapes(small.spec(
        'n-coco80-batch32')['cfg'])
    assert system.inference_config(cfg).model.embed_dim == 256

    flops = roofline.model_flops_per_image(cfg, 5, (640, 640))
    with torch.device('meta'):
        m = YOLOCLIPReference('n', embed_dim=256)
    want = roofline.forward_flops(lambda: m, (1, 3, 640, 640), (5, 256))
    assert flops == want != roofline.model_flops_per_image('n', 5)

    import time
    out = bench.run_cell(spec, 5, 1.5, True, 'cpu', time.perf_counter())
    assert out['result']['correct'], out['numbers']
    assert out['diagnostics']['gap_quantiles']['detections'] > 0
    assert 'mfu.batch' in out['result']['metrics']
    assert {'reference', 'seeded_state_dict',
            'flops_per_image'} <= set(calls)
