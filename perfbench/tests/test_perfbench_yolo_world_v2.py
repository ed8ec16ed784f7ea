"""The `yolo_world_v2` plug-in (`perfbench/architectures/yolo_world_v2.py`)
and its cell `worldv2-l-lvis1203-batch32`, on the CPU.

At the configuration's published widths: the plug-in's state layout is the
system's (built on the meta device), its seeded weights load strictly
into both the reference and the system, and its FLOP count runs on meta
and counts the text-dependent work the equations give. At a small size
(`small.py`): a traced run is correct and reads the four attention
stages, each once a replay, and the whole neck, while `yoloclip`'s program keeps its five
stages; the faults and the control make the run incorrect."""

import pytest
import torch

from perfbench import run as bench
from perfbench.architectures import yolo_world_v2 as plugin
from perfbench.lib import arch, system

from . import small

torch.set_num_threads(4)

CELL = 'worldv2-l-lvis1203-batch32'
MARKS = ['letterbox', 'backbone',
         'neck_convs.top_down.0', 'text_attn.top_down.0',
         'neck_convs.top_down.1', 'text_attn.top_down.1',
         'neck_convs.bottom_up.0', 'text_attn.bottom_up.0',
         'neck_convs.bottom_up.1', 'text_attn.bottom_up.1',
         'neck', 'head', 'postprocess']
YOLOCLIP_STAGES = ['letterbox', 'backbone', 'neck', 'head', 'postprocess']


@pytest.fixture(scope='module')
def cfg():
    c = bench.cell_spec(CELL)['cfg']
    assert arch.load(c) is plugin
    return c


def test_state_shapes_are_the_systems_at_published_widths(cfg):
    from yoloclip_tpu_torch.models.yolo_clip import YOLOWorldV2, make_model
    with torch.device('meta'):
        model = make_model(system.inference_config(cfg).model)
    assert isinstance(model, YOLOWorldV2)
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == plugin.state_shapes(cfg)
    # the published widths: C2f stages 64-128-256-512-512 with 3/6/6/3
    # blocks, neck attention guide 512 -> 256 at P4, reg tower 64 over
    # 4 x 16 bins, cls embedding 512
    assert got['backbone.image_model.stage4.1.final_conv.conv.weight'] == (
        512, 5 * 256, 1, 1)
    assert len([k for k in got if k.startswith('backbone.image_model.'
                                               'stage2.1.blocks.')
                and k.endswith('cv1.conv.weight')]) == 6
    assert got['neck.top_down_layers.0.attn_block.guide_fc.weight'] == (
        256, 512)
    assert got['neck.top_down_layers.1.final_conv.conv.weight'] == (
        256, 6 * 128, 1, 1)
    assert got['bbox_head.head_module.reg_preds.0.2.weight'] == (64, 64, 1,
                                                                 1)
    assert got['bbox_head.head_module.cls_preds.2.2.weight'] == (512, 256,
                                                                 1, 1)


def test_seeded_weights_load_strictly_into_reference_and_system(cfg):
    from yoloclip_tpu_torch.models.yolo_clip import build_model
    sd = plugin.seeded_state_dict(cfg, 2**31 + 77, 'cpu')
    plugin.reference(cfg).load_state_dict(sd, strict=True)
    model = build_model(system.inference_config(cfg).model, sd)
    head = model.bbox_head['head_module']
    for i in range(3):
        contrast = head.cls_contrasts[i]
        assert contrast.logit_scale.item() == pytest.approx(
            plugin.LOGIT_SCALE)
        assert contrast.bias.item() == plugin.LOGIT_BIAS
        torch.testing.assert_close(
            head.reg_preds[i][2].bias,
            -plugin.DFL_SLOPE * torch.arange(16.).repeat(4))


def test_flops_count_on_meta_with_the_text_work(cfg):
    """FLOPs an image at 640 x 640. What grows with the classes is the
    equations' text work: each attention layer's guide_fc (2 E embed a
    class) and score einsum (2 H W embed a class), and the contrastive
    head's product over every anchor (2 A E a class)."""
    hw = (640, 640)
    full = plugin.flops_per_image(cfg, 1203, hw)
    one = plugin.flops_per_image(cfg, 1, hw)
    E = cfg['embed_dim']
    # (level of the layer's output, its embedding width): P4 top-down,
    # P3 top-down, P4 bottom-up, P5 bottom-up
    layers = [(1, 256), (0, 128), (1, 256), (2, 256)]
    areas = [(640 // s) ** 2 for s in cfg['strides']]
    per_class = (sum(2 * E * e + 2 * areas[lvl] * e for lvl, e in layers)
                 + 2 * sum(areas) * E)
    assert full - one == 1202 * per_class
    assert 170e9 < full < 210e9


def _traced(workload, **kw):
    out = small.run(workload, seed=5, seconds=1.5, trace=True, **kw)
    return out, out['diagnostics']['host']['program']


def test_a_small_traced_run_reads_each_attention_stage_once_a_replay():
    out, program = _traced(CELL)
    assert out['result']['correct'], out['numbers']
    assert out['diagnostics']['gap_quantiles']['detections'] > 0
    calls = small.spec(CELL)['traffic']['traced_calls']
    assert program['stage_samples'] == dict.fromkeys(MARKS, calls)
    metrics = out['result']['metrics']
    assert metrics['text_attn_ms_per_image.batch']['value'] > 0
    assert (metrics['neck_total_ms_per_image.batch']['value']
            > metrics['text_attn_ms_per_image.batch']['value'])
    assert 'mfu.batch' in metrics
    assert 'neck_ms_per_image.batch' not in metrics


def test_yoloclip_keeps_its_five_stages():
    _, program = _traced('n-coco80-batch32')
    calls = small.spec('n-coco80-batch32')['traffic']['traced_calls']
    assert program['stage_samples'] == dict.fromkeys(YOLOCLIP_STAGES, calls)


@pytest.mark.parametrize('kind', ['stale', 'half', 'alter'])
def test_fault_makes_the_run_incorrect(kind, monkeypatch):
    monkeypatch.setattr(*system.fault(kind))
    out = small.run(CELL, seed=5)
    assert not out['result']['correct'], out['numbers']


def test_control_is_incorrect_at_a_small_size():
    """The control: the configuration's bf16 model with the system's int8
    path switched on."""
    out = small.run(CELL, seed=5, dtype='bfloat16', control=True)
    assert not out['result']['correct'], out['numbers']

