"""The port's W8A8 int8 deploy graph (`ops/quantize.py`, the int8 ConvBlock,
`ops/kernels/int8_conv.py`) and space-to-depth stems against the JAX
package on the CPU, at variant 'n', 96 px.

Weights: JAX random-init variables with BatchNorm moved off identity (so
the fold is exercised), carried across with `state_dict_from_jax`; the
JAX int8 variables with `quant_state_dict_from_jax`. Inputs from numpy
seeds, fed to both.

Tolerances and why:
  * int8 conv (plain version): bit-identical to an int64 numpy conv and to
    JAX's int8 `conv_general_dilated` with int32 output.
  * quantization from the same float state and calibration statistics:
    `wq` bit-identical; `wscale`, `qbias`, `act_scale` within 1 ulp; `wf`,
    `fbias` rtol 1e-6 (the same fp32 numpy arithmetic).
  * calibration statistics from each package's own float forward: rtol
    1e-5 (the two fp32 forwards differ by roundoff).
  * int8 model on the same int8 variables: scores within 1e-4, box
    relative error 1e-4, class ids equal outside near-ties (1e-4). Inputs
    to an int8 block that the two float forwards put on opposite sides of
    a .5 quantization boundary round to neighbouring int8 values; such a
    flip moves a score by more than float noise (1e-5), and at most 0.1 %
    of anchors may be so moved.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yoloclip_tpu.config import InferenceConfig as JaxInferenceConfig
from yoloclip_tpu.config import ModelConfig as JaxModelConfig
from yoloclip_tpu.inference.detector import YOLOCLIPDetector as JaxDetector
from yoloclip_tpu.models.layers import ConvBlock as JaxConvBlock
from yoloclip_tpu.models.layers import space_to_depth2 as jax_s2d
from yoloclip_tpu.models.yolo_clip import YOLOCLIP as JaxYOLOCLIP
from yoloclip_tpu.ops import preprocess as jax_pre
from yoloclip_tpu.ops import quantize as jq
from yoloclip_tpu_torch.config import InferenceConfig, ModelConfig
from yoloclip_tpu_torch.inference.detector import YOLOCLIPDetector
from yoloclip_tpu_torch.models.layers import ConvBlock
from yoloclip_tpu_torch.models.yolo_clip import YOLOCLIP, build_model
from yoloclip_tpu_torch.ops import preprocess, quantize
from yoloclip_tpu_torch.ops.kernels.int8_conv import (int8_conv,
                                                      int8_conv_plain)
from yoloclip_tpu_torch.ops.nms import batched_nms
from yoloclip_tpu_torch.utils.convert import (build_key_map,
                                              quant_state_dict_from_jax,
                                              state_dict_from_jax)

torch.set_num_threads(2)

SIZE = 96
TIE_GAP = 1e-4


def _perturb_bn(variables, rng):
    """BN off identity so the fold does work: gamma 1 + 0.1 N(0,1), beta
    0.05 N, mean 0.15 N, var exp(0.35 N) (variance 1 on average, so the
    activations keep their scale through the network)."""
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


def _block_paths(cfg):
    """Port ConvBlock name -> its flax scope path (from the key map)."""
    return {t[:-len('.conv.weight')]: f[1:-2] for t, f, _ in
            build_key_map(cfg) if t.endswith('.conv.weight')
            and f[-2:] == ('conv', 'kernel')}


def _get(tree, path):
    for p in path:
        tree = tree[p]
    return tree


@pytest.fixture(scope='module')
def setup():
    """JAX float variables (BN perturbed), the calibration batch, the JAX
    'calib_pct' amax tree, and the port's float model."""
    cfg = JaxModelConfig(image_size=(SIZE, SIZE))
    jmodel = JaxYOLOCLIP(cfg)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                     jnp.zeros((1, SIZE, SIZE, 3)),
                                     jnp.zeros((4, 512)))
    variables = _perturb_bn(jax.tree_util.tree_map(np.array, variables),
                            np.random.RandomState(1))
    rng = np.random.RandomState(2)
    images = rng.rand(2, SIZE, SIZE, 3).astype(np.float32)
    text = rng.randn(5, 512).astype(np.float32)
    text /= np.linalg.norm(text, axis=-1, keepdims=True)
    jamax = jax.tree_util.tree_map(np.asarray, jq.calibrate_amax(
        JaxYOLOCLIP(dataclasses.replace(cfg, quant='calib_pct')), variables,
        [(jnp.asarray(images), jnp.asarray(text))]))
    sd = state_dict_from_jax(variables, cfg)
    model = build_model(cfg, sd)
    return cfg, variables, images, text, jamax, sd, model


@pytest.fixture(scope='module')
def jax_int8(setup):
    """JAX's int8 variables ('max') and its int8 model's outputs."""
    cfg, variables, images, text, jamax, _, _ = setup
    qvars = jq.quantize_variables(variables, jamax, 'max')
    out = JaxYOLOCLIP(dataclasses.replace(cfg, quant='int8')).apply(
        qvars, jnp.asarray(images), jnp.asarray(text))
    return jax.tree_util.tree_map(np.asarray, qvars), out


def _port_amax_from_jax(cfg, jamax):
    """JAX's amax tree under the port's ConvBlock names."""
    out = {}
    for name, path in _block_paths(cfg).items():
        try:
            node = _get(jamax, path)
        except KeyError:
            continue
        out[name] = {k: np.float32(v) for k, v in node.items()}
    return out


# ---------------------------------------------------------------------------
# the int8 conv
# ---------------------------------------------------------------------------

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


def _taps_max(H, W, stride):
    """The most 3x3 taps (pad 1) that land inside an H x W map for any
    output pixel at `stride`."""
    Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    rows = max(sum(0 <= oy * stride + d < H for d in (-1, 0, 1))
               for oy in range(Ho))
    cols = max(sum(0 <= ox * stride + d < W for d in (-1, 0, 1))
               for ox in range(Wo))
    return rows * cols


# (cin, stride, map): the deploy graph's widths on a 9 x 7 map, then the
# CUDA kernel's edges at Cin = 16 (one half-filled 32-byte K slice): a
# 1 x 1 map, a map shorter and a map narrower than its 8 x 16 output tile,
# and a ragged 21 x 13 map.
_PLAIN_CASES = [pytest.param(cin, stride, (9, 7), id=f'{cin}-{stride}')
                for cin in (80, 128, 256) for stride in (1, 2)] + [
    pytest.param(16, stride, hw, id=f'16-{stride}-{hw[0]}x{hw[1]}')
    for hw in ((9, 7), (1, 1), (3, 17), (21, 13)) for stride in (1, 2)]


@pytest.mark.parametrize('cin,stride,hw', _PLAIN_CASES)
def test_int8_conv_plain_exact(cin, stride, hw):
    """The plain int8 conv's int32 accumulator equals an int64 numpy conv
    and JAX's int8 conv_general_dilated (int32 output) bit for bit, with
    operands at +-127 (the first half of the output channels sums
    taps Cin 127^2 at the pixel that sees the most taps, 9 in the
    interior, past fp32's exact 2^24 at Cin >= 128)."""
    H, W = hw
    rng = np.random.RandomState(cin + stride + 100 * H + W
                                if hw != (9, 7) else cin + stride)
    cout, amax = 32, 2.0
    x = rng.uniform(-amax, amax, (2, H, W, cin)).astype(np.float32)
    x[0] = amax                                  # every q at +127
    x[1, 0, 0, :3] = (-amax, amax, -amax)
    wq = rng.randint(-127, 128, (cout, 3, 3, cin)).astype(np.int8)
    wq[:cout // 2] = 127
    act = np.float32(amax / 127)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)
    acc = int8_conv_plain(xt, torch.from_numpy(wq), torch.ones(cout),
                          torch.zeros(cout), torch.tensor(act), stride,
                          epilogue=False).permute(0, 2, 3, 1).numpy()
    q = np.clip(np.round(x / act), -127, 127).astype(np.int8)
    want = _conv_int64(q, wq, stride)
    assert acc.dtype == np.int32
    assert acc.shape == (2, (H - 1) // stride + 1, (W - 1) // stride + 1,
                         cout)
    assert np.abs(want).max() == _taps_max(H, W, stride) * cin * 127 ** 2 > (
        2 ** 24 if cin >= 128 else 0)
    np.testing.assert_array_equal(acc, want)
    jacc = jax.lax.conv_general_dilated(
        jnp.asarray(q), jnp.asarray(wq.transpose(1, 2, 3, 0)),
        (stride, stride), ((1, 1), (1, 1)),
        dimension_numbers=('NHWC', 'HWIO', 'NHWC'),
        preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(acc, np.asarray(jacc))


def test_int8_conv_wrapper_checks():
    x = torch.zeros(1, 64, 4, 4)
    ok = (torch.zeros(32, 3, 3, 64, dtype=torch.int8), torch.ones(32),
          torch.zeros(32), torch.tensor(1.0))
    assert int8_conv(x, *ok, 1).shape == (1, 32, 4, 4)
    with pytest.raises(ValueError, match='Cin % 16'):
        int8_conv(torch.zeros(1, 40, 4, 4),
                  torch.zeros(32, 3, 3, 40, dtype=torch.int8), *ok[1:], 1)
    with pytest.raises(ValueError, match='stride'):
        int8_conv(x, *ok, 3)
    with pytest.raises(ValueError, match='int8 wq'):
        int8_conv(x, ok[0].float(), *ok[1:], 1)
    with pytest.raises(ValueError, match='act_scale'):
        int8_conv(x, *ok[:3], torch.ones(1), 1)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16,
                                   torch.int8])
@pytest.mark.parametrize('stride,epilogue', [(1, True), (2, True),
                                             (2, False)])
def test_int8_conv_op_cpu_impl_and_fake(dtype, stride, epilogue):
    """`yoloclip::int8_conv`: the cpu implementation is the plain version
    bit for bit; the fake gives its shape, dtype (int32 without the
    epilogue; an int8 input's given out_dtype, bf16 here, with it) and
    channels_last strides."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from yoloclip_tpu_torch.ops.kernels.int8_conv import CONV_OP
    rng = np.random.RandomState(stride + 2 * epilogue)
    x = torch.from_numpy(rng.randn(2, 64, 9, 7).astype(np.float32))
    if dtype == torch.int8:
        x = (x * 40).round().clamp(-127, 127)
    x = x.to(dtype).contiguous(memory_format=torch.channels_last)
    out_dtype = torch.bfloat16 if dtype == torch.int8 else None
    args = (x, torch.from_numpy(rng.randint(-127, 128, (128, 3, 3, 64))
                                .astype(np.int8)),
            torch.from_numpy(rng.rand(128).astype(np.float32) / 100),
            torch.from_numpy(rng.randn(128).astype(np.float32)),
            torch.tensor(0.02), stride, epilogue, out_dtype)
    real = CONV_OP.op(*args)
    assert torch.equal(real, int8_conv_plain(*args))
    with FakeTensorMode() as mode:
        fake = CONV_OP.op(*(mode.from_tensor(a) if isinstance(a, torch.Tensor)
                            else a for a in args))
    assert (fake.shape, fake.dtype, fake.stride()) == (
        real.shape, real.dtype, real.stride())
    assert real.dtype == ((out_dtype or dtype) if epilogue else torch.int32)
    assert real.is_contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize('k,cin,cout,stride', [(3, 64, 128, 1),
                                               (3, 80, 160, 2),
                                               (3, 256, 256, 1),
                                               (1, 8, 8, 1)])
def test_int8_convblock_matches_jax(k, cin, cout, stride):
    """One ConvBlock, JAX quant='int8' on JAX's quantized variables against
    the port's int8 ConvBlock on the same variables carried across (an
    int8 block, or a BN-folded one for 1x1)."""
    rng = np.random.RandomState(cin)
    x = (rng.randn(2, 12, 10, cin) * 0.5).astype(np.float32)
    block = JaxConvBlock(cout, k, stride)
    variables = jax.tree_util.tree_map(np.array, block.init(
        jax.random.PRNGKey(0), jnp.asarray(x)))
    variables['params']['conv']['kernel'] = (
        rng.randn(k, k, cin, cout) * 0.2).astype(np.float32)
    variables = _perturb_bn({'params': {'b': variables['params']},
                             'batch_stats': {'b': variables['batch_stats']}},
                            rng)
    variables = {c: variables[c]['b'] for c in variables}
    qv = jq.quantize_variables(variables, {'in_amax': np.abs(x).max()})
    want = JaxConvBlock(cout, k, stride, quant='int8').apply(
        qv, jnp.asarray(x))
    port = ConvBlock(cin, cout, k, stride, quant='int8')
    p = jax.tree_util.tree_map(np.array, qv['params'])
    if 'wq' in p:
        sd = {'wq': torch.from_numpy(np.ascontiguousarray(
                  p['wq'].transpose(3, 0, 1, 2))),
              'wscale': torch.from_numpy(p['wscale']),
              'qbias': torch.from_numpy(p['qbias']),
              'act_scale': torch.tensor(p['act_scale'])}
    else:
        sd = {'wf': torch.from_numpy(p['wf'].transpose(3, 2, 0, 1).copy()),
              'fbias': torch.from_numpy(p['fbias'])}
    port.load_state_dict(sd, strict=True)
    assert port.mode == ('int8' if k == 3 else 'folded')
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# calibration and the quantized state
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('calibration', ['max', 'percentile'])
def test_quantize_state_matches_jax(setup, calibration):
    """From the same float variables and the same calibration batch: every
    eligible block's wq bit-identical to JAX quantize_variables', its
    scales within 1 ulp, the folded blocks' wf/fbias within rtol 1e-6;
    and the port's calibration statistics equal JAX's (rtol 1e-5)."""
    cfg, variables, images, text, jamax, sd, model = setup
    qvars = jax.tree_util.tree_map(np.asarray, jq.quantize_variables(
        variables, jamax, calibration))
    want = quant_state_dict_from_jax(qvars, cfg)
    pamax = quantize.calibrate_amax(
        model, [(torch.from_numpy(images), torch.from_numpy(text))],
        percentile=calibration == 'percentile')
    jnames = _port_amax_from_jax(cfg, jamax)
    assert set(pamax) == set(jnames) and len(pamax) == 72
    stat = 'in_p999' if calibration == 'percentile' else 'in_amax'
    for name, node in pamax.items():
        np.testing.assert_allclose(node[stat], jnames[name][stat],
                                   rtol=1e-5, err_msg=name)
    for amax in (pamax, jnames):
        got = quantize.quantize_state(sd, amax, calibration)
        assert set(got) == set(want)
        n_wq = 0
        for k, v in want.items():
            g, w = got[k].numpy(), v.numpy()
            if k.endswith('.wq'):
                n_wq += 1
                np.testing.assert_array_equal(g, w, err_msg=k)
            elif k.endswith(('.wscale', '.qbias')) or (
                    k.endswith('.act_scale') and amax is jnames):
                np.testing.assert_array_max_ulp(g, w, maxulp=1)
            elif k.endswith('.act_scale'):
                np.testing.assert_allclose(g, w, rtol=1e-5, err_msg=k)
            elif k.endswith(('.wf', '.fbias')):
                np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7,
                                           err_msg=k)
            else:
                np.testing.assert_array_equal(g, w, err_msg=k)
        assert n_wq == 22


def test_percentile_over_2_24_elements():
    """torch.quantile refuses inputs above 2^24 elements; the port's
    percentile takes them and equals jnp.quantile(x, 0.999) (its fp32
    position arithmetic, linear interpolation)."""
    n = (1 << 24) + 12345
    ax = np.abs(np.random.RandomState(3).randn(n)).astype(np.float32)
    t = torch.from_numpy(ax)
    with pytest.raises(RuntimeError):
        torch.quantile(t, 0.999)
    got = quantize.percentile_999(t).item()
    want = float(jnp.quantile(jnp.asarray(ax), 0.999))
    np.testing.assert_array_max_ulp(np.float32(got), np.float32(want),
                                    maxulp=1)
    small = ax[:1001]
    np.testing.assert_array_max_ulp(
        np.float32(quantize.percentile_999(torch.from_numpy(small)).item()),
        np.float32(jnp.quantile(jnp.asarray(small), 0.999)), maxulp=1)


def test_quantize_refusals(setup):
    cfg, _, _, _, jamax, sd, _ = setup
    amax = _port_amax_from_jax(cfg, jamax)
    with pytest.raises(ValueError, match='calibration'):
        quantize.quantize_state(sd, amax, 'entropy')
    plain = {n: {'in_amax': v['in_amax']} for n, v in amax.items()}
    with pytest.raises(KeyError, match='in_p999'):
        quantize.quantize_state(sd, plain, 'percentile')
    with pytest.raises(KeyError, match='missing calibration amax'):
        quantize.quantize_state(sd, {}, 'max')
    with pytest.raises(ValueError, match='forward hooks'):
        YOLOCLIP(ModelConfig(image_size=(64, 64), quant='calib'))


# ---------------------------------------------------------------------------
# the int8 model and the detector
# ---------------------------------------------------------------------------

def test_int8_model_matches_jax(setup, jax_int8):
    """The port's int8 model on JAX's int8 variables (quant_state_dict_
    from_jax) against JAX quant='int8' on the same inputs."""
    cfg, _, images, text, _, _, _ = setup
    qvars, want = jax_int8
    qmodel = YOLOCLIP(dataclasses.replace(cfg, quant='int8')).eval()
    qmodel.load_state_dict(quant_state_dict_from_jax(qvars, cfg), strict=True)
    with torch.no_grad():
        got = qmodel(torch.from_numpy(images), torch.from_numpy(text))
    ds = np.abs(got['scores'].numpy() - np.asarray(want['scores']))
    assert ds.max() <= 1e-4
    assert (ds > 1e-5).mean() <= 1e-3          # int8 rounding flips
    wb = np.asarray(want['boxes'])
    rel = np.abs(got['boxes'].numpy() - wb) / np.maximum(np.abs(wb), 1)
    assert rel.max() <= 1e-4
    top2 = np.sort(np.asarray(want['similarity']), axis=-1)[..., -2:]
    tie = (top2[..., 1] - top2[..., 0]) < TIE_GAP
    assert not ((got['class_ids'].numpy() != np.asarray(want['class_ids']))
                & ~tie).any()


def test_quantize_model_matches_jax_int8(setup, jax_int8):
    """quantize_model (the port's own calibration, fold and quantization)
    gives an int8 model whose outputs agree with JAX's int8 model."""
    cfg, _, images, text, _, sd, model = setup
    _, want = jax_int8
    x, t = torch.from_numpy(images), torch.from_numpy(text)
    qmodel = quantize.quantize_model(model, sd, [(x, t)])
    assert qmodel.cfg.quant == 'int8'
    assert sum(m.mode == 'int8' for m in qmodel.modules()
               if isinstance(m, ConvBlock)) == 22
    with torch.no_grad():
        got = qmodel(x, t)
    # each package calibrated on its own float forward: act_scale may sit
    # an ulp apart, which moves the quantization grid itself, so more
    # inputs round apart than on the same variables; the bounds on the
    # outputs stay those of test_int8_model_matches_jax
    ds = np.abs(got['scores'].numpy() - np.asarray(want['scores']))
    assert ds.max() <= 1e-4
    wb = np.asarray(want['boxes'])
    rel = np.abs(got['boxes'].numpy() - wb) / np.maximum(np.abs(wb), 1)
    assert rel.max() <= 1e-4


def test_build_quant_forward_matches_detector_path(setup):
    """build_quant_forward(nms=...) equals quantize_model + the model +
    batched_nms on the same canvases."""
    cfg, _, images, text, _, sd, model = setup
    x, t = torch.from_numpy(images), torch.from_numpy(text)
    nms = {'conf_threshold': -1.0, 'iou_threshold': 0.45, 'topk': 64,
           'max_detections': 8}
    fwd = quantize.build_quant_forward(model, sd, t, x, nms=nms)
    got = fwd(x)
    qmodel = quantize.quantize_model(model, sd, [(x, t)])
    with torch.no_grad():
        out = qmodel(x, t)
    want = batched_nms(out['boxes'], out['scores'], out['class_ids'], -1.0,
                       0.45, topk=64, max_detections=8)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    raw = quantize.build_quant_forward(model, sd, t, x)(x)
    assert raw['boxes'].shape == (2, cfg.num_anchors(), 4)


@pytest.fixture(scope='module')
def detector_pair(setup, tmp_path_factory):
    """The JAX and the port detector on the same float variables and JSON
    vocabulary, conf -1.0."""
    cfg, variables, _, _, _, sd, _ = setup
    rng = np.random.RandomState(4)
    vocab = rng.randn(4, 512)
    vocab /= np.linalg.norm(vocab, axis=-1, keepdims=True)
    path = str(tmp_path_factory.mktemp('vocab') / 'v.json')
    with open(path, 'w') as f:
        json.dump({n: v.tolist() for n, v in zip('abcd', vocab)}, f)
    kw = dict(conf_threshold=-1.0, nms_topk=48, max_detections=8,
              host_preprocess=False)
    jdet = JaxDetector(vocab_path=path, variables=variables,
                       config=JaxInferenceConfig(model=cfg, **kw))
    det = YOLOCLIPDetector(InferenceConfig(model=ModelConfig(
        image_size=(SIZE, SIZE)), **kw), vocab_path=path, state_dict=sd,
        device='cpu')
    return jdet, det


def test_detector_quantize_int8_matches_jax(detector_pair):
    """YOLOCLIPDetector.quantize_int8 against the JAX detector's on the
    same calibration frames; then detect_batch on other frames. The swap
    cannot be undone: a second call raises."""
    jdet, det = detector_pair
    rng = np.random.RandomState(5)
    calib = (rng.rand(2, 70, 96, 3) * 255).astype(np.uint8)
    frames = (rng.rand(2, 80, 96, 3) * 255).astype(np.uint8)
    jdet.quantize_int8(calib)
    det.quantize_int8(calib)
    assert det.quantized and det.config.model.quant == 'int8'
    with pytest.raises(RuntimeError, match='already quantized'):
        det.quantize_int8(calib)
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


# ---------------------------------------------------------------------------
# the space-to-depth stems and their letterbox
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('frame_hw', [(96, 96), (70, 150)])
def test_letterbox_u8_s2d_matches_jax(frame_hw):
    """The uint8 space-to-depth letterbox: identity and resizing cases;
    the canvases equal JAX's (the fp32 bilinear results round to the same
    bytes, at most 1 LSB apart where both land within roundoff of .5)."""
    x = (np.random.RandomState(7).rand(2, *frame_hw, 3) * 255).astype(
        np.uint8)
    got, scale = preprocess.letterbox_batch_u8_s2d(torch.from_numpy(x),
                                                   (SIZE, SIZE))
    want, jscale = jax_pre.letterbox_batch_u8_s2d(jnp.asarray(x),
                                                  (SIZE, SIZE))
    assert got.dtype == torch.uint8 and got.shape == want.shape
    assert np.float32(scale) == np.float32(jscale)
    diff = np.abs(got.numpy().astype(int) - np.asarray(want).astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
    one, _ = preprocess.letterbox_u8_s2d(torch.from_numpy(x[0]),
                                         (SIZE, SIZE))
    assert torch.equal(one, got[0])


@pytest.mark.parametrize('stem', ['stem_s2d', 'stem_u8_s2d'])
@pytest.mark.parametrize('quant', ['none', 'int8'])
def test_stems_match_plain_and_jax(setup, jax_int8, stem, quant):
    """A space-to-depth stem against the plain stem on the same weights
    (the JAX package's own tolerances, tests/test_quantize.py: s2d 1e-5;
    the uint8 canvas boxes 1e-4, scores rtol 1e-4 atol 1e-5, ids equal)
    and against JAX's model with the same stem."""
    cfg, variables, images, text, _, sd, model = setup
    qvars, _ = jax_int8
    pcfg = dataclasses.replace(cfg, quant=quant)
    if quant == 'int8':
        sd = quant_state_dict_from_jax(qvars, cfg)
        jvars = qvars
    else:
        jvars = variables
    plain = YOLOCLIP(pcfg).eval()
    plain.load_state_dict(sd, strict=True)
    other = YOLOCLIP(dataclasses.replace(pcfg, **{stem: True})).eval()
    other.load_state_dict(sd, strict=True)
    u8 = np.round(images * 255).astype(np.uint8)
    x = u8.astype(np.float32) / 255.0
    t = torch.from_numpy(text)
    xin = (jax_s2d(jnp.asarray(u8)) if stem == 'stem_u8_s2d'
           else jnp.asarray(x))
    with torch.no_grad():
        a = plain(torch.from_numpy(x), t)
        b = other(torch.from_numpy(np.array(xin)), t)
    jb = JaxYOLOCLIP(dataclasses.replace(cfg, quant=quant, **{stem: True})
                     ).apply(jvars, xin, jnp.asarray(text))
    (brt, bat), (srt, sat) = ((1e-5, 1e-5), (1e-5, 1e-5)) if (
        stem == 'stem_s2d') else ((1e-4, 1e-4), (1e-4, 1e-5))
    np.testing.assert_allclose(b['boxes'].numpy(), a['boxes'].numpy(),
                               rtol=brt, atol=bat)
    np.testing.assert_allclose(b['scores'].numpy(), a['scores'].numpy(),
                               rtol=srt, atol=sat)
    np.testing.assert_array_equal(b['class_ids'].numpy(),
                                  a['class_ids'].numpy())
    np.testing.assert_allclose(b['scores'].numpy(), np.asarray(jb['scores']),
                               rtol=0, atol=1e-4)
    wb = np.asarray(jb['boxes'])
    assert (np.abs(b['boxes'].numpy() - wb) / np.maximum(np.abs(wb), 1)
            ).max() <= 1e-4
