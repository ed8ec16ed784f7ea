"""The port's `ops/reparam.py::build_reparam_forward` against the JAX
package's, at variant 'n', 128 px, fp32, on the same JAX random-init
weights (`state_dict_from_jax`) and the same numpy inputs: the default
(I-Pool kept), `skip_image_pool=True`, with `nms`, and with a 1-D
`class_mask`. JAX runs at 'highest' matmul precision (tests/conftest.py).

Tolerances: class ids exact; scores atol 1e-5; boxes atol 1e-3 px plus
rtol 1e-5 (random init decodes to boxes of 1e4 px through exp(wh)); the
text embeddings atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yoloclip_tpu.config import ModelConfig as JaxModelConfig
from yoloclip_tpu.models.yolo_clip import YOLOCLIP as JaxYOLOCLIP
from yoloclip_tpu.ops.reparam import (
    build_reparam_forward as jax_build_reparam_forward)
from yoloclip_tpu_torch.config import ModelConfig
from yoloclip_tpu_torch.models.yolo_clip import build_model
from yoloclip_tpu_torch.ops.reparam import build_reparam_forward
from yoloclip_tpu_torch.utils.convert import state_dict_from_jax

torch.set_num_threads(2)

SIZE = 128
NMS = {'conf_threshold': 0.0, 'iou_threshold': 0.45, 'topk': 64,
       'max_detections': 16}
MASK = np.array([True, False, True, True, False])


@pytest.fixture(scope='module')
def setup():
    jcfg = JaxModelConfig(image_size=(SIZE, SIZE))
    jmodel = JaxYOLOCLIP(jcfg)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(3),
                                     jnp.zeros((1, SIZE, SIZE, 3)),
                                     jnp.zeros((5, 512)))
    cfg = ModelConfig(image_size=(SIZE, SIZE))
    model = build_model(cfg, state_dict_from_jax(variables, cfg))
    rng = np.random.RandomState(0)
    images = rng.rand(1, SIZE, SIZE, 3).astype(np.float32)
    vocab = rng.randn(5, 512).astype(np.float32)
    vocab /= np.linalg.norm(vocab, axis=-1, keepdims=True)
    return jmodel, variables, model, images, vocab


def agree(got, want, keys=('scores', 'boxes', 'class_ids')):
    for k in keys:
        g, w = got[k].numpy(), np.asarray(want[k])
        assert g.shape == w.shape, k
        if k == 'class_ids':
            np.testing.assert_array_equal(g, w)
        elif k == 'boxes':
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-3)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)


@pytest.mark.parametrize('kw', [{}, {'skip_image_pool': True},
                                {'class_mask': MASK}],
                         ids=['default', 'skip_image_pool', 'class_mask'])
def test_reparam_forward_matches_jax(setup, kw):
    jmodel, variables, model, images, vocab = setup
    want = jax_build_reparam_forward(
        jmodel, variables, jnp.asarray(vocab),
        **{k: jnp.asarray(v) if k == 'class_mask' else v
           for k, v in kw.items()})(jnp.asarray(images))
    got = build_reparam_forward(
        model, torch.from_numpy(vocab),
        **{k: torch.from_numpy(v) if k == 'class_mask' else v
           for k, v in kw.items()})(images)
    agree(got, want)
    np.testing.assert_allclose(got['text_embeddings'].numpy(),
                               np.asarray(want['text_embeddings']),
                               rtol=0, atol=1e-5)
    if 'class_mask' in kw:
        assert np.isin(got['class_ids'].numpy(), np.flatnonzero(MASK)).all()
        assert 'similarity' in got and torch.isneginf(
            got['similarity'][..., ~torch.from_numpy(MASK)]).all()
    if kw.get('skip_image_pool'):
        # the text passes through unmodified
        np.testing.assert_allclose(got['text_embeddings'][0].numpy(), vocab,
                                   rtol=0, atol=1e-6)


def test_reparam_forward_with_nms_matches_jax(setup):
    jmodel, variables, model, images, vocab = setup
    want = jax_build_reparam_forward(jmodel, variables, jnp.asarray(vocab),
                                     nms=NMS)(jnp.asarray(images))
    got = build_reparam_forward(model, torch.from_numpy(vocab),
                                nms=NMS)(images)
    assert set(got) == set(want)
    for k in ('count', 'valid', 'prefilter_saturated'):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    agree(got, want)
    assert int(got['count'][0]) > 0
    assert not got['scores'].requires_grad and got['scores'].is_inference()
