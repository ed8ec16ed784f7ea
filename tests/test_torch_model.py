"""The port's model against the JAX package at variant 'n', 128 px, fp32.

Weights: JAX random-init variables carried over with `state_dict_from_jax`.
Inputs: numpy seeds, fed to both. JAX runs at 'highest' matmul precision
(tests/conftest.py).

Tolerances: activations rtol 1e-4 with atol 1e-4 x the tensor's largest
magnitude (fp32, different conv algorithms and summation orders); scores
and similarities atol 1e-5; boxes atol 1e-3 px plus rtol 1e-5 (random
init decodes to boxes of 1e4 px and more through exp(wh), where fp32
resolves ~1e-3 px); class ids exact except at
anchors whose top-2 similarity gap is below 1e-5 (near ties).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yoloclip_tpu.config import ModelConfig
from yoloclip_tpu.models.backbone import YOLOv8Backbone as JaxBackbone
from yoloclip_tpu.models.neck import RepVLPAN as JaxNeck
from yoloclip_tpu.models.yolo_clip import YOLOCLIP as JaxYOLOCLIP
from yoloclip_tpu_torch.models.yolo_clip import YOLOCLIP, build_model
from yoloclip_tpu_torch.utils.convert import state_dict_from_jax

torch.set_num_threads(2)

SIZE = 128
TIE_GAP = 1e-5


@pytest.fixture(scope='module')
def setup():
    cfg = ModelConfig(image_size=(SIZE, SIZE))
    jmodel = JaxYOLOCLIP(cfg)
    variables = jax.jit(lambda k, x, t: jmodel.init(k, x, t,
                                                    with_aux_box=True))(
        jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)),
        jnp.zeros((4, 512)))
    sd = state_dict_from_jax(variables, cfg)
    model = build_model(cfg, sd)
    rng = np.random.RandomState(0)
    images = rng.rand(2, SIZE, SIZE, 3).astype(np.float32)
    text = rng.randn(6, 512).astype(np.float32)
    text /= np.linalg.norm(text, axis=-1, keepdims=True)
    return cfg, jmodel, variables, model, images, text


def close(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale)


def nchw(x):
    return torch.from_numpy(np.array(x)).permute(
        0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


def sub(variables, name):
    return {'params': variables['params'][name],
            'batch_stats': variables['batch_stats'][name]}


def test_state_dict_loads_strict_with_aux_box(setup):
    cfg, _, _, model, _, _ = setup
    assert hasattr(model.contrastive_heads[0], 'box_conv')
    # without the aux keys the heads carry no box tower
    sd = {k: v for k, v in model.state_dict().items() if '.box_conv.' not in k}
    plain = YOLOCLIP(cfg)
    plain.load_state_dict(sd, strict=True)
    assert not hasattr(plain.contrastive_heads[0], 'box_conv')


def test_backbone_matches_jax(setup):
    cfg, _, variables, model, images, _ = setup
    want = JaxBackbone('n').apply(sub(variables, 'backbone'),
                                  jnp.asarray(images))
    with torch.no_grad():
        got = model.backbone(nchw(images))
    for g, w in zip(got, want):
        assert g.is_contiguous(memory_format=torch.channels_last)
        close(nhwc(g), w)


def test_neck_matches_jax(setup):
    cfg, _, variables, model, images, text = setup
    feats = JaxBackbone('n').apply(sub(variables, 'backbone'),
                                   jnp.asarray(images))
    fc = tuple(cfg.feature_channels())
    text_b = np.broadcast_to(text[None], (2,) + text.shape)
    want, want_text = JaxNeck(fc, fc, 512, cfg.neck_bottlenecks).apply(
        sub(variables, 'neck'), feats, jnp.asarray(text_b))
    with torch.no_grad():
        got, got_text = model.neck([nchw(np.asarray(f)) for f in feats],
                                   torch.from_numpy(text_b.copy()))
    close(got_text, want_text)
    for g, w in zip(got, want):
        close(nhwc(g), w)


def _ids_agree(got_ids, want_ids, similarity):
    top2 = np.sort(np.asarray(similarity), axis=-1)[..., -2:]
    tie = (top2[..., 1] - top2[..., 0]) < TIE_GAP
    assert not ((got_ids != np.asarray(want_ids)) & ~tie).any()


def _variant_setup(variant):
    """Variant s/m/l/x at 64 px: seeded random weights made into flax
    variables by the JAX package's own converter (quicker than compiling
    its init at these widths) and carried back with `state_dict_from_jax`,
    and seeded inputs."""
    from yoloclip_tpu.utils.convert import convert_reference_state_dict
    cfg = ModelConfig(backbone_variant=variant, image_size=(64, 64))
    jmodel = JaxYOLOCLIP(cfg)
    variables = convert_reference_state_dict(
        build_model(cfg, seed=1).state_dict(), cfg, with_aux_box=False)
    model = build_model(cfg, state_dict_from_jax(variables, cfg))
    rng = np.random.RandomState(1)
    images = rng.rand(2, 64, 64, 3).astype(np.float32)
    text = rng.randn(6, 512).astype(np.float32)
    text /= np.linalg.norm(text, axis=-1, keepdims=True)
    return cfg, jmodel, variables, model, images, text


@pytest.mark.parametrize('variant', ['n', 's', 'm', 'l', 'x'])
def test_composite_unfused_matches_jax(setup, variant):
    """Variant 'n' at 128 px with the file's tolerances; s, m, l and x at
    64 px, where the port's scores came within 4e-7 and boxes within 2e-6
    relative of JAX's (ROADMAP C, checked in a scratch run): asserted at
    scores 1e-6 and relative boxes 1e-5 (fp32; the widths of 'x' are those
    of the int8 kernel's Cin = 80 case)."""
    cfg, jmodel, variables, model, images, text = (
        setup if variant == 'n' else _variant_setup(variant))
    want = jmodel.apply(variables, jnp.asarray(images), jnp.asarray(text))
    with torch.no_grad():
        got = model(torch.from_numpy(images), torch.from_numpy(text))
    assert set(got) == set(want)
    if variant != 'n':
        wb = np.asarray(want['boxes'])
        rel = np.abs(got['boxes'].numpy() - wb) / np.maximum(np.abs(wb), 1)
        assert rel.max() <= 1e-5
        np.testing.assert_allclose(got['scores'].numpy(),
                                   np.asarray(want['scores']), rtol=0,
                                   atol=1e-6)
        _ids_agree(got['class_ids'].numpy(), want['class_ids'],
                   want['similarity'])
        return
    np.testing.assert_allclose(got['boxes'].numpy(), np.asarray(want['boxes']),
                               rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(got['scores'].numpy(),
                               np.asarray(want['scores']), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got['similarity'].numpy(),
                               np.asarray(want['similarity']), rtol=0,
                               atol=1e-5)
    _ids_agree(got['class_ids'].numpy(), want['class_ids'],
               want['similarity'])
    close(got['obj_embeddings'], want['obj_embeddings'])
    close(got['text_embeddings'], want['text_embeddings'])
    for g, w in zip(got['box_preds'], want['box_preds']):
        close(g, w)


def test_composite_fused_matches_jax_interpret(setup):
    """fused_scores=True: the port's plain folded version on CPU against
    the Pallas folded kernel in interpret mode (what the JAX composite runs
    off-TPU when asked for fused scores)."""
    cfg, jmodel, variables, model, images, text = setup
    want = jmodel.apply(variables, jnp.asarray(images), jnp.asarray(text),
                        fused_scores=True)
    unfused = jmodel.apply(variables, jnp.asarray(images), jnp.asarray(text))
    with torch.no_grad():
        got = model(torch.from_numpy(images), torch.from_numpy(text),
                    fused_scores=True)
    assert 'similarity' not in got and 'obj_embeddings' not in got
    np.testing.assert_allclose(got['scores'].numpy(),
                               np.asarray(want['scores']), rtol=0, atol=1e-5)
    _ids_agree(got['class_ids'].numpy(), want['class_ids'],
               unfused['similarity'])
    np.testing.assert_allclose(got['boxes'].numpy(), np.asarray(want['boxes']),
                               rtol=1e-5, atol=1e-3)


def test_random_init_is_seeded():
    cfg = ModelConfig(image_size=(SIZE, SIZE))
    a, b, c = build_model(cfg, seed=3), build_model(cfg, seed=3), \
        build_model(cfg, seed=4)
    wa = a.backbone.stem.conv.weight
    assert torch.equal(wa, b.backbone.stem.conv.weight)
    assert not torch.equal(wa, c.backbone.stem.conv.weight)
