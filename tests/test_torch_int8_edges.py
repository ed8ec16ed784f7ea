"""The port's int8-stored activation edges (`models/layers.py::QT`, the
int8 conv's int8-input mode) against the JAX package on the CPU, at
variant 'n', 96 px.

Both packages' thresholds (`STORE_INT8_MIN_ELEMS`, read at import from
YOLOCLIP_STORE_INT8_MIN_ELEMS) are set to 0 for the module, so every
`store_out` edge with 32 channels or more is stored: 9 at variant 'n'.
The JAX models are built after the patch and their variables are checked
to hold `out_scale`, so no trace from before the patch can hide a miss.

Weights and inputs: tests/test_torch_quantize.py's (JAX random-init
variables with BatchNorm off identity, carried across with
`state_dict_from_jax`; inputs from numpy seeds, fed to both).

Tolerances (those of tests/test_torch_quantize.py, and why there):
  * int8 conv with int8 input (plain version): the accumulator equals an
    int64 numpy conv bit for bit, the output the float-input path's on
    x = q s bit for bit;
  * out_scale from the same calibration statistics within 1 ulp; from
    each package's own float forward rtol 1e-5;
  * the int8 model on the same variables: scores 1e-4, boxes relative
    1e-4, class ids equal outside near-ties (1e-4); bf16 against each
    package's own fp32: the median box and mean score error within 1.5x
    and 1.2x JAX's (tests/test_torch_bf16.py's rule);
  * the detector: counts and ids exact, scores 1e-4, boxes rtol 1e-4
    atol 1e-2;
  * a 2-way height split against the unsplit call: the same stored edges;
    tests/test_torch_spatial.py's int8 bounds (scores rtol 1e-3 atol
    2e-3, boxes rtol 1e-4 atol 1e-3, ids exact).
"""

import dataclasses
import json
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yoloclip_tpu.config import InferenceConfig as JaxInferenceConfig
from yoloclip_tpu.config import ModelConfig as JaxModelConfig
from yoloclip_tpu.inference.detector import YOLOCLIPDetector as JaxDetector
from yoloclip_tpu.models import layers as jax_layers
from yoloclip_tpu.models.yolo_clip import YOLOCLIP as JaxYOLOCLIP
from yoloclip_tpu.ops import quantize as jq
from yoloclip_tpu_torch.config import InferenceConfig, ModelConfig
from yoloclip_tpu_torch.inference.detector import YOLOCLIPDetector
from yoloclip_tpu_torch.models import layers
from yoloclip_tpu_torch.models.layers import QT, ConvBlock
from yoloclip_tpu_torch.models.yolo_clip import (YOLOCLIP, build_model,
                                                 cast_compute_dtype)
from yoloclip_tpu_torch.ops import quantize
from yoloclip_tpu_torch.ops.kernels.int8_conv import (int8_conv,
                                                      int8_conv_plain)
from yoloclip_tpu_torch.parallel.mesh import create_mesh
from yoloclip_tpu_torch.parallel.spatial import spatialize_detector
from yoloclip_tpu_torch.utils.convert import (build_key_map,
                                              quant_state_dict_from_jax,
                                              state_dict_from_jax)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 96
TIE_GAP = 1e-4
# The 9 stored edges at variant 'n' (the port's block names)
EDGES = {'backbone.stage1.1.cv3', 'backbone.stage3.1.bottlenecks.0.cv1',
         'backbone.stage4.1.bottlenecks.0.cv1',
         'backbone.stage4.1.bottlenecks.1.cv1', 'backbone.stage4.1.cv3',
         'neck.text_csplayers.1.bottlenecks.0.cv1',
         'neck.text_csplayers.1.bottlenecks.1.cv1',
         'neck.text_csplayers.2.bottlenecks.0.cv1',
         'neck.text_csplayers.2.bottlenecks.1.cv1'}
# The int8 conv blocks that read an edge as int8 (3x3, 64 -> 128)
INT8_READERS = {'backbone.stage4.1.bottlenecks.0.cv2',
                'backbone.stage4.1.bottlenecks.1.cv2',
                'neck.text_csplayers.2.bottlenecks.0.cv2',
                'neck.text_csplayers.2.bottlenecks.1.cv2'}


def _set_threshold(mp, value):
    mp.setattr(jax_layers, 'STORE_INT8_MIN_ELEMS', value)
    mp.setattr(layers, 'STORE_INT8_MIN_ELEMS', value)


@pytest.fixture(scope='module')
def edges_on():
    mp = pytest.MonkeyPatch()
    _set_threshold(mp, 0)
    yield
    mp.undo()


def _perturb_bn(variables, rng):
    """tests/test_torch_quantize.py's BatchNorm off identity: gamma 1 +
    0.1 N(0,1), beta 0.05 N, mean 0.15 N, var exp(0.35 N)."""
    def walk(p, s):
        if isinstance(p.get('bn'), dict) and 'scale' in p['bn']:
            n = p['bn']['scale'].shape
            p['bn']['scale'] = (1 + 0.1 * rng.randn(*n)).astype(np.float32)
            p['bn']['bias'] = (0.05 * rng.randn(*n)).astype(np.float32)
            s['bn']['mean'] = (0.15 * rng.randn(*n)).astype(np.float32)
            s['bn']['var'] = np.exp(0.35 * rng.randn(*n)).astype(np.float32)
        for k, v in p.items():
            if isinstance(v, dict) and k != 'bn' and k in s:
                walk(v, s[k])
    walk(variables['params'], variables['batch_stats'])
    return variables


def _scopes_with(tree, leaf, path=()):
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out += _scopes_with(v, leaf, path + (k,))
        elif k == leaf:
            out.append(path)
    return out


def _block_path(cfg):
    """Port ConvBlock name -> its flax scope path."""
    return {t[:-len('.conv.weight')]: f[1:-2] for t, f, _ in
            build_key_map(cfg) if t.endswith('.conv.weight')
            and f[-2:] == ('conv', 'kernel')}


@pytest.fixture(scope='module')
def setup(edges_on):
    """The port's float model and its flax twin, the calibration batch,
    JAX's 'calib' statistics and int8 variables with edges on, and JAX's
    int8 outputs in fp32 and bf16."""
    cfg = ModelConfig(image_size=(SIZE, SIZE))
    jcfg = JaxModelConfig(image_size=(SIZE, SIZE))
    variables = jax.jit(JaxYOLOCLIP(jcfg).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)),
        jnp.zeros((4, 512)))
    variables = _perturb_bn(jax.tree_util.tree_map(np.array, variables),
                            np.random.RandomState(1))
    sd = state_dict_from_jax(variables, cfg)
    model = build_model(cfg, sd)
    rng = np.random.RandomState(2)
    images = rng.rand(2, SIZE, SIZE, 3).astype(np.float32)
    text = rng.randn(5, 512).astype(np.float32)
    text /= np.linalg.norm(text, axis=-1, keepdims=True)
    x, t = jnp.asarray(images), jnp.asarray(text)
    jamax = jax.tree_util.tree_map(np.asarray, jq.calibrate_amax(
        JaxYOLOCLIP(dataclasses.replace(jcfg, quant='calib')), variables,
        [(x, t)]))
    qvars = jax.tree_util.tree_map(
        np.asarray, jq.quantize_variables(variables, jamax, 'max'))
    # the JAX graph really stores the 9 edges at this threshold
    paths = _block_path(cfg)
    assert sorted(_scopes_with(qvars['params'], 'out_scale')) == sorted(
        paths[n] for n in EDGES)
    want = {}
    for dt in ('float32', 'bfloat16'):
        jm = JaxYOLOCLIP(dataclasses.replace(jcfg, quant='int8', dtype=dt))
        want[dt] = jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float32),
            dict(jax.jit(jm.apply)(qvars, x, t)))
    return types.SimpleNamespace(cfg=cfg, model=model, sd=sd, images=images,
                                 text=text, jamax=jamax, qvars=qvars,
                                 want=want, variables=variables)


def _edges_of(qmodel, x, t):
    """Run qmodel; return (blocks that returned a QT, int8 conv blocks that
    read one, the outputs)."""
    stored, read = set(), set()
    hooks = []
    for n, m in qmodel.named_modules():
        if isinstance(m, ConvBlock):
            hooks.append(m.register_forward_hook(
                lambda mod, a, o, n=n: stored.add(n) if isinstance(o, QT)
                else None))
            if m.mode == 'int8':
                hooks.append(m.register_forward_pre_hook(
                    lambda mod, a, n=n: read.add(n) if isinstance(a[0], QT)
                    else None))
    try:
        with torch.no_grad():
            out = qmodel(x, t)
    finally:
        for h in hooks:
            h.remove()
    return stored, read, out


def _assert_int8_close(got, want):
    """tests/test_torch_quantize.py's int8 bounds."""
    ds = np.abs(got['scores'].float().numpy() - want['scores'])
    assert ds.max() <= 1e-4
    assert (ds > 1e-5).mean() <= 1e-3          # int8 rounding flips
    wb = want['boxes']
    rel = np.abs(got['boxes'].float().numpy() - wb) / np.maximum(
        np.abs(wb), 1)
    assert rel.max() <= 1e-4
    top2 = np.sort(want['similarity'], axis=-1)[..., -2:]
    tie = (top2[..., 1] - top2[..., 0]) < TIE_GAP
    assert not ((got['class_ids'].numpy() != want['class_ids']) & ~tie).any()


# ---------------------------------------------------------------------------
# the threshold and the int8-input conv
# ---------------------------------------------------------------------------

def test_store_int8_eligible_matches_jax(monkeypatch):
    """(a) The port's predicate equals JAX's on a grid of (h, w, c,
    threshold), read from the module global at call time; the defaults
    agree ((1 << 62) with the variable unset)."""
    assert layers.STORE_INT8_MIN_ELEMS == jax_layers.STORE_INT8_MIN_ELEMS
    if 'YOLOCLIP_STORE_INT8_MIN_ELEMS' not in os.environ:
        assert layers.STORE_INT8_MIN_ELEMS == 1 << 62
    for thr in (0, 1, 32 * 20 * 20, 819200, 1 << 62):
        _set_threshold(monkeypatch, thr)
        for h in (1, 3, 20, 160):
            for w in (1, 7, 20, 160):
                for c in (16, 31, 32, 64, 256):
                    assert layers.store_int8_eligible(h, w, c) == \
                        jax_layers.store_int8_eligible(h, w, c), (h, w, c,
                                                                  thr)


def test_threshold_read_at_import():
    """The port reads YOLOCLIP_STORE_INT8_MIN_ELEMS at import."""
    env = dict(os.environ, YOLOCLIP_STORE_INT8_MIN_ELEMS='819200',
               PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, '-c', 'from yoloclip_tpu_torch.models import '
         'layers; print(layers.STORE_INT8_MIN_ELEMS)'],
        env=env, capture_output=True, text=True, check=True, cwd=REPO)
    assert out.stdout.split() == ['819200']


def _conv_int64(q, w, stride):
    """q (B, H, W, C), w (Cout, 3, 3, C) int -> int64 NHWC conv, pad 1."""
    B, H, W, C = q.shape
    qp = np.pad(q.astype(np.int64), ((0, 0), (1, 1), (1, 1), (0, 0)))
    Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    out = np.zeros((B, Ho, Wo, w.shape[0]), np.int64)
    for ky in range(3):
        for kx in range(3):
            patch = qp[:, ky:ky + stride * Ho:stride,
                       kx:kx + stride * Wo:stride]
            out += np.einsum('bhwc,oc->bhwo', patch,
                             w[:, ky, kx].astype(np.int64))
    return out


@pytest.mark.parametrize('cin,stride,out_dtype', [
    (64, 1, torch.float32), (64, 1, torch.bfloat16), (256, 2, torch.float32),
    (16, 2, torch.bfloat16)])
def test_int8_input_conv_plain(cin, stride, out_dtype):
    """(e) The plain int8 conv on int8 input: the accumulator equals an
    int64 numpy conv (operands at +-127 included), and the output equals
    the float-input path's on x = q s, in out_dtype."""
    rng = np.random.RandomState(cin + stride)
    q = rng.randint(-127, 128, (2, 9, 7, cin)).astype(np.int8)
    q[0] = 127
    wq = rng.randint(-127, 128, (32, 3, 3, cin)).astype(np.int8)
    wq[:16] = 127
    s = torch.tensor(np.float32(0.0173))
    ws = torch.from_numpy(rng.rand(32).astype(np.float32) / 50)
    qb = torch.from_numpy(rng.randn(32).astype(np.float32))
    xq = torch.from_numpy(q).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)
    w = torch.from_numpy(wq)
    acc = int8_conv_plain(xq, w, ws, qb, s, stride, epilogue=False)
    np.testing.assert_array_equal(acc.permute(0, 2, 3, 1).numpy(),
                                  _conv_int64(q, wq, stride))
    got = int8_conv(xq, w, ws, qb, s, stride, out_dtype=out_dtype)
    assert got.dtype == out_dtype
    assert got.is_contiguous(memory_format=torch.channels_last)
    xf = (xq.float() * s).contiguous(memory_format=torch.channels_last)
    want = int8_conv(xf, w, ws, qb, s, stride).to(out_dtype)
    assert torch.equal(got, want)


def test_int8_input_wrapper_checks():
    q = torch.zeros(1, 64, 4, 4, dtype=torch.int8)
    ok = (torch.zeros(32, 3, 3, 64, dtype=torch.int8), torch.ones(32),
          torch.zeros(32), torch.tensor(1.0))
    with pytest.raises(ValueError, match='out_dtype'):
        int8_conv(q, *ok, 1)
    with pytest.raises(ValueError, match='out_dtype'):
        int8_conv(q, *ok, 1, out_dtype=torch.float16)
    with pytest.raises(ValueError, match='not out_dtype'):
        int8_conv(q.float(), *ok, 1, out_dtype=torch.bfloat16)
    assert int8_conv(q, *ok, 1, out_dtype=torch.float32).dtype == \
        torch.float32


def test_bf16_store_quantizes_before_the_cast(monkeypatch):
    """A bf16 BN-folded block stores round(y / out_scale) of its fp32
    post-SiLU y, as JAX quantizes before any cast: not of y rounded to
    bf16 first."""
    _set_threshold(monkeypatch, 0)
    rng = np.random.RandomState(4)
    block = ConvBlock(32, 64, 1, quant='int8', store_out=True)
    block.load_state_dict({
        'wf': torch.from_numpy(rng.randn(64, 32, 1, 1).astype(np.float32)),
        'fbias': torch.from_numpy(rng.randn(64).astype(np.float32)),
        'out_scale': torch.tensor(np.float32(0.011))})
    x = torch.from_numpy(rng.randn(2, 32, 20, 20).astype(np.float32)).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        out = block(x)
    assert isinstance(out, QT) and out.dtype == torch.bfloat16
    y32 = torch.nn.functional.silu(torch.nn.functional.conv2d(
        x, block.wf.to(torch.bfloat16)) + block.fbias[:, None, None])
    want = torch.clamp(torch.round(y32 / block.out_scale), -127, 127)
    assert torch.equal(out.q, want.to(torch.int8))
    late = torch.clamp(torch.round(y32.bfloat16().float() / block.out_scale),
                       -127, 127).to(torch.int8)
    assert not torch.equal(out.q, late)


# ---------------------------------------------------------------------------
# calibration, conversion (ROADMAP C8) and the int8 model
# ---------------------------------------------------------------------------

def test_quantize_state_out_scale_matches_jax(setup):
    """(b) quantize_state gives out_scale on exactly JAX's 9 blocks: from
    JAX's statistics within 1 ulp of quantize_variables', from the port's
    own calibration within rtol 1e-5."""
    cfg, jamax = setup.cfg, setup.jamax
    want = quant_state_dict_from_jax(setup.qvars, cfg)
    paths = _block_path(cfg)
    jstats = {}
    for n, p in paths.items():
        node = _get(jamax, p)
        if node is not None:
            jstats[n] = {k: np.float32(v) for k, v in node.items()}
    pamax = quantize.calibrate_amax(
        setup.model, [(torch.from_numpy(setup.images),
                       torch.from_numpy(setup.text))])
    assert {n for n, v in pamax.items() if 'out_store' in v} == EDGES
    for amax, rtol in ((jstats, None), (pamax, 1e-5)):
        got = quantize.quantize_state(setup.sd, amax)
        keys = {k for k in got if k.endswith('.out_scale')}
        assert keys == {k for k in want if k.endswith('.out_scale')} == {
            f'{n}.out_scale' for n in EDGES}
        for k in keys:
            if rtol is None:
                np.testing.assert_array_max_ulp(got[k].numpy(),
                                                want[k].numpy(), maxulp=1)
            else:
                np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                           rtol=rtol, err_msg=k)


def _get(tree, path):
    for p in path:
        if p not in tree:
            return None
        tree = tree[p]
    return tree


def test_convert_carries_out_scale(setup):
    """(f) ROADMAP C8: JAX's out_scale converts (it was dropped, so the
    port ran the edges in float); a stray out_scale raises naming the
    block; JAX variables without edges load strictly as before, and the
    buffers follow the state dict."""
    cfg, qvars = setup.cfg, setup.qvars
    sd = quant_state_dict_from_jax(qvars, cfg)
    assert {k for k in sd if k.endswith('out_scale')} == {
        f'{n}.out_scale' for n in EDGES}
    qmodel = YOLOCLIP(dataclasses.replace(cfg, quant='int8'))
    qmodel.load_state_dict(sd, strict=True)
    stray = jax.tree_util.tree_map(lambda a: a, qvars)
    stray['params']['neck']['text_csplayers_0']['cv1']['out_scale'] = (
        np.float32(0.1))
    with pytest.raises(KeyError, match='neck.text_csplayers.0.cv1'):
        quant_state_dict_from_jax(stray, cfg)
    stray = jax.tree_util.tree_map(lambda a: a, qvars)
    stray['params']['neck']['image_pooling_attention']['out_scale'] = (
        np.float32(0.1))
    with pytest.raises(KeyError, match='image_pooling_attention'):
        quant_state_dict_from_jax(stray, cfg)
    plain_amax = jax.tree_util.tree_map(lambda a: a, setup.jamax)
    for p in _scopes_with(plain_amax, 'out_store'):
        node = _get(plain_amax, p)
        del node['out_store'], node['out_amax']
    plain = quant_state_dict_from_jax(jax.tree_util.tree_map(
        np.asarray, jq.quantize_variables(setup.variables, plain_amax)), cfg)
    assert not any(k.endswith('out_scale') for k in plain)
    qmodel.load_state_dict(plain, strict=True)
    assert all(getattr(m, 'out_scale', None) is None
               for m in qmodel.modules() if isinstance(m, ConvBlock))
    # at threshold 0 an eligible block with no out_scale refuses to run
    with pytest.raises(KeyError, match='backbone.stage1.1.cv3'):
        with torch.no_grad():
            qmodel(torch.zeros(1, SIZE, SIZE, 3), torch.zeros(4, 512))


def test_int8_edges_model_matches_jax(setup):
    """(c) The port's int8 model on JAX's edge-on variables (through the
    repaired converter) against JAX quant='int8': the 9 edges stored, 4
    read as int8 by int8 conv blocks, outputs within the int8 bounds."""
    cfg = setup.cfg
    qmodel = YOLOCLIP(dataclasses.replace(cfg, quant='int8')).eval()
    qmodel.load_state_dict(quant_state_dict_from_jax(setup.qvars, cfg),
                           strict=True)
    stored, read, got = _edges_of(qmodel, torch.from_numpy(setup.images),
                                  torch.from_numpy(setup.text))
    assert stored == EDGES and read == INT8_READERS
    _assert_int8_close(got, setup.want['float32'])


def _errors(b16, b32):
    """(median relative box error, mean abs score error) of a bf16 run
    against its own fp32 run."""
    bb = np.asarray(b16['boxes'], np.float64)
    bf = np.asarray(b32['boxes'], np.float64)
    rel = np.abs(bb - bf) / np.maximum(np.abs(bf), 1.0)
    ds = np.abs(np.asarray(b16['scores'], np.float64)
                - np.asarray(b32['scores'], np.float64))
    return float(np.median(rel)), float(ds.mean())


def test_int8_edges_bf16_within_jax(setup):
    """(c, bf16) The port's bf16 int8 model with edges (the edges
    quantized from fp32, dequantized to bf16) against its own fp32 run,
    within tests/test_torch_bf16.py's factors of JAX's bf16 against its
    fp32."""
    cfg, want = setup.cfg, setup.want
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        qmodel = YOLOCLIP(dataclasses.replace(cfg, quant='int8')).eval()
        qmodel.load_state_dict(quant_state_dict_from_jax(setup.qvars, cfg),
                               strict=True)
        stored, read, o = _edges_of(cast_compute_dtype(qmodel, dt),
                                    torch.from_numpy(setup.images),
                                    torch.from_numpy(setup.text))
        assert stored == EDGES and read == INT8_READERS
        out[dt] = {k: o[k].float().numpy() for k in ('boxes', 'scores')}
    j_box, j_score = _errors(want['bfloat16'], want['float32'])
    p_box, p_score = _errors(out[torch.bfloat16], out[torch.float32])
    msg = (f'bf16 vs own fp32: port box {p_box:.3e} score {p_score:.3e}; '
           f'JAX box {j_box:.3e} score {j_score:.3e}')
    assert p_box <= 1.5 * j_box, msg
    assert p_score <= 1.2 * j_score, msg


def test_quantize_model_edges_match_jax(setup):
    """(d) The port's own quantize_model with edges on against JAX's int8
    model (tests/test_torch_quantize.py's bounds for this pair)."""
    want = setup.want
    x, t = torch.from_numpy(setup.images), torch.from_numpy(setup.text)
    qmodel = quantize.quantize_model(setup.model, setup.sd, [(x, t)])
    assert {k[:-len('.out_scale')] for k in qmodel.state_dict()
            if k.endswith('.out_scale')} == EDGES
    stored, read, got = _edges_of(qmodel, x, t)
    assert stored == EDGES and read == INT8_READERS
    ds = np.abs(got['scores'].numpy() - want['float32']['scores'])
    assert ds.max() <= 1e-4
    wb = want['float32']['boxes']
    rel = np.abs(got['boxes'].numpy() - wb) / np.maximum(np.abs(wb), 1)
    assert rel.max() <= 1e-4


# ---------------------------------------------------------------------------
# the detector, the height split and export
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def vocab_path(tmp_path_factory):
    rng = np.random.RandomState(4)
    vocab = rng.randn(4, 512)
    vocab /= np.linalg.norm(vocab, axis=-1, keepdims=True)
    path = str(tmp_path_factory.mktemp('edges') / 'v.json')
    with open(path, 'w') as f:
        json.dump({n: v.tolist() for n, v in zip('abcd', vocab)}, f)
    return path


def _port_detector(setup, path):
    return YOLOCLIPDetector(
        InferenceConfig(model=ModelConfig(image_size=(SIZE, SIZE)),
                        conf_threshold=-1.0, nms_topk=48, max_detections=8,
                        host_preprocess=False),
        vocab_path=path, state_dict=setup.sd, device='cpu')


def test_detector_quantize_int8_edges_match_jax(setup, vocab_path):
    """(g) detector.quantize_int8 with edges on against the JAX
    detector's, then detect_batch on other frames."""
    jdet = JaxDetector(vocab_path=vocab_path, variables=setup.variables,
                       config=JaxInferenceConfig(
                           model=JaxModelConfig(image_size=(SIZE, SIZE)),
                           conf_threshold=-1.0, nms_topk=48,
                           max_detections=8, host_preprocess=False))
    det = _port_detector(setup, vocab_path)
    rng = np.random.RandomState(5)
    calib = (rng.rand(2, 70, 96, 3) * 255).astype(np.uint8)
    frames = (rng.rand(2, 80, 96, 3) * 255).astype(np.uint8)
    jdet.quantize_int8(calib)
    det.quantize_int8(calib)
    assert len(_scopes_with(jax.tree_util.tree_map(
        np.asarray, jdet.variables)['params'], 'out_scale')) == len(EDGES)
    assert sum(k.endswith('.out_scale')
               for k in det.model.state_dict()) == len(EDGES)
    got, want = det.detect_batch(frames), jdet.detect_batch(frames)
    np.testing.assert_array_equal(got['count'].numpy(),
                                  np.asarray(want['count']))
    np.testing.assert_array_equal(got['class_ids'].numpy(),
                                  np.asarray(want['class_ids']))
    np.testing.assert_allclose(got['scores'].numpy(),
                               np.asarray(want['scores']), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got['boxes'].numpy(),
                               np.asarray(want['boxes']), rtol=1e-4,
                               atol=1e-2)


@pytest.mark.parametrize('threshold', [0, 2304])
def test_height_split_stores_the_same_edges(setup, vocab_path, monkeypatch,
                                            threshold):
    """(h) A 2-way height split (1x2 mesh of the CPU, one thread a shard)
    stores the edges the unsplit call stores and gives its detections. At
    2304 only the 24x24x32 and 3x3x256 outputs store at 96 px: each shard
    holds fewer rows of stage 4 than the threshold needs, so the decision
    must be the whole frame's."""
    _set_threshold(monkeypatch, threshold)
    det = _port_detector(setup, vocab_path)
    frames = (np.random.RandomState(6).rand(2, SIZE, SIZE, 3)
              * 255).astype(np.uint8)
    det.quantize_int8(frames)
    calls = []

    def record(mod, args, out, n):
        if isinstance(out, QT):
            calls.append(n)
    hooks = [m.register_forward_hook(
        lambda mod, a, o, n=n: record(mod, a, o, n))
        for n, m in det.model.named_modules() if isinstance(m, ConvBlock)]
    want = det.detect_batch(frames)
    unsplit = sorted(calls)
    calls.clear()
    spatialize_detector(det, create_mesh(n_data=1, n_model=2,
                                         devices=['cpu'] * 2),
                        height_axis='model')
    got = det.detect_batch(frames)
    for h in hooks:
        h.remove()
    assert set(unsplit) == (EDGES if threshold == 0 else {
        'backbone.stage1.1.cv3', 'backbone.stage4.1.cv3'})
    assert sorted(calls) == sorted(unsplit * 2)    # on each shard
    np.testing.assert_array_equal(got['class_ids'].numpy(),
                                  want['class_ids'].numpy())
    np.testing.assert_allclose(got['scores'].numpy(), want['scores'].numpy(),
                               rtol=1e-3, atol=2e-3)
    np.testing.assert_allclose(got['boxes'].numpy(), want['boxes'].numpy(),
                               rtol=1e-4, atol=1e-3)


def test_int8_edges_artifact_equals_eager(setup, tmp_path):
    """An int8 model exported with edges on (64 px) holds the 4 int8-input
    `yoloclip::int8_conv` calls and runs bit for bit as the eager model."""
    from yoloclip_tpu_torch.utils.export import export_detector, load_exported
    cfg = ModelConfig(image_size=(64, 64))
    model = build_model(cfg, seed=3)
    rng = np.random.RandomState(8)
    x = torch.from_numpy(rng.rand(2, 64, 64, 3).astype(np.float32))
    text = torch.from_numpy(rng.randn(5, 512).astype(np.float32))
    qmodel = quantize.quantize_model(model, quantize.float_state(model),
                                     [(x, text)])
    path = export_detector(qmodel, text, (2, 64, 64),
                           str(tmp_path / 'edges.pt2'), include_nms=False,
                           device='cpu')
    graph = torch.export.load(path).graph
    convs = [n for n in graph.nodes
             if str(n.target) == 'yoloclip.int8_conv.default']
    assert len(convs) == 22
    assert sum(n.args[0].meta['val'].dtype == torch.int8
               for n in convs) == len(INT8_READERS)
    got = load_exported(path, device='cpu')(x)
    with torch.no_grad():
        want = qmodel(x, text)
    for k in got:
        assert torch.equal(got[k], want[k]), k
