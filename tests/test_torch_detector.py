"""The port's detector against the JAX detector on the CPU.

Both load the same JAX random-init weights (the port through
`state_dict_from_jax`) and the same JSON vocabulary, and run the device
letterbox path (`host_preprocess=False`) on the same uint8 frames.

Tolerances: counts, validity, saturation flags and class ids exact; scores
atol 1e-5; boxes (rescaled and clipped to the frame) atol 1e-3 px, and the
int-truncated boxes of `detect` equal.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yoloclip_tpu.config import InferenceConfig, ModelConfig
from yoloclip_tpu.inference.detector import YOLOCLIPDetector as JaxDetector
from yoloclip_tpu.inference.detector import _pack_detections as jax_pack
from yoloclip_tpu.models.yolo_clip import YOLOCLIP as JaxYOLOCLIP
from yoloclip_tpu_torch.inference.detector import (YOLOCLIPDetector,
                                                   _pack_detections)
from yoloclip_tpu_torch.utils.convert import state_dict_from_jax

torch.set_num_threads(2)

SIZE = 128
NAMES = ['cat', 'dog', 'person', 'car', 'tree']


@pytest.fixture(scope='module')
def pair(tmp_path_factory):
    cfg = InferenceConfig(model=ModelConfig(image_size=(SIZE, SIZE)),
                          conf_threshold=0.0, nms_topk=64, max_detections=16,
                          host_preprocess=False)
    rng = np.random.RandomState(0)
    vocab = rng.randn(len(NAMES), 512)
    vocab /= np.linalg.norm(vocab, axis=-1, keepdims=True)
    path = str(tmp_path_factory.mktemp('vocab') / 'vocab.json')
    with open(path, 'w') as f:
        json.dump({n: v.tolist() for n, v in zip(NAMES, vocab)}, f)
    jmodel = JaxYOLOCLIP(cfg.model)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(1),
                                     jnp.zeros((1, SIZE, SIZE, 3)),
                                     jnp.zeros((4, 512)))
    jdet = JaxDetector(vocab_path=path, config=cfg, variables=variables)
    det = YOLOCLIPDetector(cfg, vocab_path=path,
                           state_dict=state_dict_from_jax(variables,
                                                          cfg.model),
                           device='cpu')
    return jdet, det, cfg, path


def test_vocabulary_and_names(pair):
    jdet, det, _, _ = pair
    assert det.class_names == jdet.class_names == NAMES
    np.testing.assert_array_equal(det.offline_vocabulary.numpy(),
                                  np.asarray(jdet.offline_vocabulary))


def test_detect_batch_matches_jax(pair):
    jdet, det, _, _ = pair
    imgs = (np.random.RandomState(11).rand(2, 96, 150, 3) * 255).astype(
        np.uint8)
    want = jdet.detect_batch(imgs)
    got = det.detect_batch(imgs)
    assert set(got) == set(want)
    for k in ('count', 'valid', 'prefilter_saturated', 'class_ids'):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    np.testing.assert_allclose(got['scores'].numpy(),
                               np.asarray(want['scores']), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got['boxes'].numpy(), np.asarray(want['boxes']),
                               rtol=0, atol=1e-3)
    assert (got['count'] > 0).all()
    packed = _pack_detections(got).numpy()
    np.testing.assert_allclose(
        packed, np.asarray(jax_pack(jax.tree_util.tree_map(jnp.asarray,
                                                           want))),
        rtol=0, atol=1e-3)


def test_detect_matches_jax(pair):
    jdet, det, _, _ = pair
    img = (np.random.RandomState(3).rand(120, 200, 3) * 255).astype(np.uint8)
    want = jdet.detect(img)
    got = det.detect(img)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g['class_id'] == w['class_id']
        assert g['class_name'] == w['class_name']
        assert g['box'] == w['box']
        assert abs(g['score'] - w['score']) <= 1e-5


def test_draw_detections(pair):
    _, det, _, _ = pair
    img = (np.random.RandomState(4).rand(80, 100, 3) * 255).astype(np.uint8)
    drawn = det.draw_detections(img, det.detect(img))
    assert drawn.shape == img.shape and drawn.dtype == np.uint8


def test_unported_paths_raise(pair):
    _, det, cfg, path = pair
    img = np.zeros((64, 64, 3), np.uint8)
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        det.detect(img, text_prompts=['a cat'])
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        det.detect_batch(img[None], text_prompts=['a cat'])
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        YOLOCLIPDetector(cfg, device='cpu')                 # no vocabulary
    host = InferenceConfig(model=cfg.model, host_preprocess=True)
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        YOLOCLIPDetector(host, vocab_path=path, device='cpu')
    int8 = InferenceConfig(model=ModelConfig(image_size=(SIZE, SIZE),
                                             quant='int8'))
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        YOLOCLIPDetector(int8, vocab_path=path, device='cpu')
