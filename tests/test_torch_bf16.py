"""bf16 keeps BatchNorm and the obj_2 projection in fp32, as the JAX package
does (ROADMAP C4).

The JAX ConvBlock normalises with `nn.BatchNorm(param_dtype=float32)` and
its folded similarity reads the fp32 obj_2 kernel; the port used to cast
the whole model to bf16, which rounded every BN statistic and affine
parameter. At variant 'n', 192 px, with BN moved off identity, each
package's bf16 run is compared with its own fp32 run; the port's errors
must stay within 1.5x (median relative box error) and 1.2x (mean score
error) of JAX's. Before the repair the port's median box error was 5x
JAX's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yoloclip_tpu.models.yolo_clip import YOLOCLIP as JaxYOLOCLIP
from yoloclip_tpu_torch.config import InferenceConfig, ModelConfig
from yoloclip_tpu_torch.inference.detector import YOLOCLIPDetector
from yoloclip_tpu_torch.models.heads import Proj1x1
from yoloclip_tpu_torch.models.layers import ConvBlock
from yoloclip_tpu_torch.models.yolo_clip import build_model, cast_compute_dtype
from yoloclip_tpu_torch.text.model import (CLIPTextTransformer,
                                           init_text_weights)
from yoloclip_tpu_torch.utils.convert import state_dict_from_jax

torch.set_num_threads(2)

SIZE = 192


def _perturb_bn(variables, rng):
    """BN off identity, as ROADMAP C4's measurement: mean 0.3 N(0,1), var
    0.5 exp(0.7 N(0,1)), gamma 1 + 0.2 N(0,1), beta 0.1 N(0,1)."""
    def walk(p, s):
        if 'bn' in p and isinstance(p['bn'], dict) and 'scale' in p['bn']:
            n = p['bn']['scale'].shape
            p['bn']['scale'] = (1 + 0.2 * rng.randn(*n)).astype(np.float32)
            p['bn']['bias'] = (0.1 * rng.randn(*n)).astype(np.float32)
            s['bn']['mean'] = (0.3 * rng.randn(*n)).astype(np.float32)
            s['bn']['var'] = (0.5 * np.exp(0.7 * rng.randn(*n))).astype(
                np.float32)
        for k, v in p.items():
            if isinstance(v, dict) and k != 'bn' and k in s:
                walk(v, s[k])
    walk(variables['params'], variables['batch_stats'])
    return variables


@pytest.fixture(scope='module')
def weights():
    cfg = ModelConfig(image_size=(SIZE, SIZE))
    variables = jax.jit(JaxYOLOCLIP(cfg).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)),
        jnp.zeros((4, 512)))
    variables = jax.tree_util.tree_map(np.array, variables)
    variables = _perturb_bn(variables, np.random.RandomState(4))
    return cfg, variables, state_dict_from_jax(variables, cfg)


def test_bf16_detector_keeps_bn_and_obj2_fp32(weights, tmp_path):
    """(a) In a bf16 detector every BatchNorm weight, bias, running mean and
    variance is fp32, the convs are bf16, and the folded similarity's
    obj_2 kernel and bias are the fp32 source weights; after quantize_int8
    the folded and int8 blocks' parameters are fp32 too."""
    cfg, _, sd = weights
    tower = str(tmp_path / 'tower.pth')
    tiny = CLIPTextTransformer(width=64, layers=1)
    init_text_weights(tiny, torch.Generator().manual_seed(0))
    torch.save(tiny.state_dict(), tower)
    icfg = InferenceConfig(model=dataclasses.replace(
        cfg, image_size=(64, 64), dtype='bfloat16'))
    det = YOLOCLIPDetector(icfg, class_names=['a', 'b'], state_dict=sd,
                           text_checkpoint=tower, device='cpu')
    bns = [m for m in det.model.modules()
           if isinstance(m, torch.nn.BatchNorm2d)]
    assert len(bns) == 72
    for m in bns:
        for t in (m.weight, m.bias, m.running_mean, m.running_var):
            assert t.dtype == torch.float32
    assert det.model.backbone.stem.conv.weight.dtype == torch.bfloat16
    for i, head in enumerate(det.model.contrastive_heads):
        proj = head.obj_embed_conv[2]
        assert isinstance(proj, Proj1x1)
        kernel, bias = proj.weights()
        key = f'contrastive_heads.{i}.obj_embed_conv.2'
        assert kernel.dtype == bias.dtype == torch.float32
        assert torch.equal(kernel, sd[f'{key}.weight'][:, :, 0, 0].t())
        assert torch.equal(bias, sd[f'{key}.bias'])
    det.quantize_int8((np.random.RandomState(0).rand(2, 48, 64, 3) * 255
                       ).astype(np.uint8))
    blocks = [m for m in det.model.modules() if isinstance(m, ConvBlock)]
    assert {m.mode for m in blocks} == {'int8', 'folded'}
    for m in blocks:
        names = (('wscale', 'qbias', 'act_scale') if m.mode == 'int8'
                 else ('wf', 'fbias'))
        assert all(getattr(m, n).dtype == torch.float32 for n in names)


def _errors(b16, b32):
    """(median relative box error, mean abs score error) of a bf16 run
    against its own fp32 run."""
    bb, bf = np.asarray(b16['boxes'], np.float64), np.asarray(
        b32['boxes'], np.float64)
    rel = np.abs(bb - bf) / np.maximum(np.abs(bf), 1.0)
    ds = np.abs(np.asarray(b16['scores'], np.float64)
                - np.asarray(b32['scores'], np.float64))
    return float(np.median(rel)), float(ds.mean())


def test_bf16_error_within_jax(weights):
    """(b) ROADMAP C4's measurement as a test: variant 'n', 192 px, BN
    perturbed, 2 images, 80 unit-norm text rows; each package's bf16 model
    against its own fp32 model (the port's cast by cast_compute_dtype, as
    the detector casts it)."""
    cfg, variables, sd = weights
    rng = np.random.RandomState(5)
    images = rng.rand(2, SIZE, SIZE, 3).astype(np.float32)
    text = rng.randn(80, 512).astype(np.float32)
    text /= np.linalg.norm(text, axis=-1, keepdims=True)
    jout = {}
    for dt in ('float32', 'bfloat16'):
        jm = JaxYOLOCLIP(dataclasses.replace(cfg, dtype=dt))
        o = jax.jit(jm.apply)(variables, jnp.asarray(images),
                              jnp.asarray(text))
        jout[dt] = {k: np.asarray(o[k], np.float32)
                    for k in ('boxes', 'scores')}
    pout = {}
    for dt in (torch.float32, torch.bfloat16):
        model = cast_compute_dtype(build_model(cfg, sd), dt)
        with torch.no_grad():
            o = model(torch.from_numpy(images), torch.from_numpy(text))
        pout[dt] = {k: o[k].float().numpy() for k in ('boxes', 'scores')}
    j_box, j_score = _errors(jout['bfloat16'], jout['float32'])
    p_box, p_score = _errors(pout[torch.bfloat16], pout[torch.float32])
    msg = (f'bf16 vs own fp32: port box {p_box:.3e} score {p_score:.3e}; '
           f'JAX box {j_box:.3e} score {j_score:.3e}')
    assert p_box <= 1.5 * j_box, msg
    assert p_score <= 1.2 * j_score, msg
