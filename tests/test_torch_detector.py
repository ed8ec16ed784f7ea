"""The port's detector against the JAX detector on the CPU.

Both load the same JAX random-init weights (the port through
`state_dict_from_jax`) and run the device letterbox path
(`host_preprocess=False`) on the same uint8 frames; `default_pair` keeps
the default `host_preprocess='auto'`, the host-letterbox canvas path of
both packages. The vocabulary comes
from the same JSON file (`pair`), or through class names and free-text
prompts (`prompt_pair`); both pairs load the same miniature CLIP text
tower `.npz` (width 64, 2 layers).

Tolerances: counts, validity, saturation flags and class ids exact; scores
atol 1e-5; boxes (rescaled and clipped to the frame) atol 1e-3 px, and the
int-truncated boxes of `detect` equal; text-tower vocabularies atol 1e-5.
"""

import dataclasses
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yoloclip_tpu.config import InferenceConfig as JaxInferenceConfig
from yoloclip_tpu.config import ModelConfig as JaxModelConfig
from yoloclip_tpu.inference.detector import YOLOCLIPDetector as JaxDetector
from yoloclip_tpu.inference.detector import _pack_detections as jax_pack
from yoloclip_tpu.models.yolo_clip import YOLOCLIP as JaxYOLOCLIP
from yoloclip_tpu.text.encoder import save_text_tower_params
from yoloclip_tpu.text.model import CLIPTextTransformer as JaxTower
from yoloclip_tpu_torch.config import InferenceConfig, ModelConfig
from yoloclip_tpu_torch.inference.detector import (YOLOCLIPDetector,
                                                   _pack_detections)
from yoloclip_tpu_torch.text.model import (CLIPTextTransformer,
                                           init_text_weights)
from yoloclip_tpu_torch.utils.convert import state_dict_from_jax

torch.set_num_threads(2)

SIZE = 128
NAMES = ['cat', 'dog', 'person', 'car', 'tree']
PROMPTS = ['a red car', 'café au lait', '日本の猫', 'a dog', 'tree']


def configs(**kw):
    """The same settings as the JAX package's config and the port's."""
    return (JaxInferenceConfig(model=JaxModelConfig(image_size=(SIZE, SIZE)),
                               **kw),
            InferenceConfig(model=ModelConfig(image_size=(SIZE, SIZE)), **kw))


@pytest.fixture(scope='module')
def weights():
    jcfg, cfg = configs(conf_threshold=0.0, nms_topk=64, max_detections=16,
                        host_preprocess=False)
    jmodel = JaxYOLOCLIP(jcfg.model)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(1),
                                     jnp.zeros((1, SIZE, SIZE, 3)),
                                     jnp.zeros((4, 512)))
    return jcfg, cfg, variables, state_dict_from_jax(variables, cfg.model)


@pytest.fixture(scope='module')
def pair(weights, tower_npz, tmp_path_factory):
    """Both detectors serving the same JSON vocabulary."""
    jcfg, cfg, variables, sd = weights
    rng = np.random.RandomState(0)
    vocab = rng.randn(len(NAMES), 512)
    vocab /= np.linalg.norm(vocab, axis=-1, keepdims=True)
    path = str(tmp_path_factory.mktemp('vocab') / 'vocab.json')
    with open(path, 'w') as f:
        json.dump({n: v.tolist() for n, v in zip(NAMES, vocab)}, f)
    jdet = JaxDetector(vocab_path=path, config=jcfg, variables=variables,
                       text_checkpoint=tower_npz)
    det = YOLOCLIPDetector(cfg, vocab_path=path, state_dict=sd,
                           text_checkpoint=tower_npz, device='cpu')
    return jdet, det, cfg, path


@pytest.fixture(scope='module')
def default_pair(weights, pair):
    """Both detectors at the default host_preprocess ('auto'), serving the
    JSON vocabulary of `pair`."""
    _, _, variables, sd = weights
    _, _, _, path = pair
    jcfg, cfg = configs(conf_threshold=0.0, nms_topk=64, max_detections=16)
    assert cfg.host_preprocess == jcfg.host_preprocess == 'auto'
    jdet = JaxDetector(vocab_path=path, config=jcfg, variables=variables)
    det = YOLOCLIPDetector(cfg, vocab_path=path, state_dict=sd, device='cpu')
    return jdet, det


@pytest.fixture(scope='module')
def tower_npz(tmp_path_factory):
    """A miniature text tower (width 64, 2 layers) saved as .npz by the JAX
    package, every param perturbed by numpy noise."""
    params = JaxTower(width=64, layers=2, heads=1, output_dim=512).init(
        jax.random.PRNGKey(2), jnp.zeros((1, 77), jnp.int32))['params']
    rng = np.random.RandomState(1)
    params = jax.tree_util.tree_map(
        lambda p: (np.asarray(p) + 0.02 * rng.randn(*np.shape(p))
                   ).astype(np.float32), params)
    npz = str(tmp_path_factory.mktemp('tower') / 'text_tower.npz')
    save_text_tower_params(params, npz)
    return npz


@pytest.fixture(scope='module')
def prompt_pair(weights, tower_npz):
    """Both detectors with the vocabulary of NAMES built by the same
    miniature text tower."""
    jcfg, cfg, variables, sd = weights
    jdet = JaxDetector(class_names=NAMES, config=jcfg,
                       text_checkpoint=tower_npz, variables=variables)
    det = YOLOCLIPDetector(cfg, class_names=NAMES, text_checkpoint=tower_npz,
                           state_dict=sd, device='cpu')
    return jdet, det


def assert_batches_agree(got, want):
    assert set(got) == set(want)
    for k in ('count', 'valid', 'prefilter_saturated', 'class_ids'):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    np.testing.assert_allclose(got['scores'].numpy(),
                               np.asarray(want['scores']), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got['boxes'].numpy(), np.asarray(want['boxes']),
                               rtol=0, atol=1e-3)


def assert_detections_agree(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g['class_id'] == w['class_id']
        assert g['class_name'] == w['class_name']
        assert g['box'] == w['box']
        assert abs(g['score'] - w['score']) <= 1e-5


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
    assert_batches_agree(got, want)
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
    assert_detections_agree(got, want)


@pytest.mark.parametrize('host_preprocess', ['auto', True])
def test_detect_default_config_matches_jax(default_pair, host_preprocess):
    """At the default config both detectors letterbox on the host (the
    native library is built here) into the canvas program; the port used
    to letterbox on the device under 'auto' and its scores differed from
    the JAX detector's by 3e-4."""
    jdet, det = default_pair
    jdet.config = dataclasses.replace(jdet.config,
                                      host_preprocess=host_preprocess)
    det.config = dataclasses.replace(det.config,
                                     host_preprocess=host_preprocess)
    img = (np.random.RandomState(3).rand(120, 200, 3) * 255).astype(np.uint8)
    assert_detections_agree(det.detect(img), jdet.detect(img))
    assert det._host_letterbox_available() and jdet._host_letterbox_available()
    canvas, scale = det._host_letterbox(img)
    jcanvas, jscale = jdet._host_letterbox(img)
    np.testing.assert_array_equal(canvas, jcanvas)
    assert scale == jscale


@pytest.mark.parametrize('backend', ['cv2', 'PIL', 'numpy'])
def test_host_letterbox_without_native_matches_jax(default_pair, backend,
                                                   monkeypatch):
    """Where the native library is unavailable, both packages' host
    letterbox resizes with cv2, else PIL, else numpy; the canvases are
    byte-identical, and with cv2 or PIL `detect()` at the default config
    still takes the canvas path and agrees. With neither, both fall back
    to the device letterbox."""
    from yoloclip_tpu import native as jnative
    from yoloclip_tpu_torch import native
    jdet, det = default_pair
    monkeypatch.setattr(native, 'available', lambda: False)
    monkeypatch.setattr(jnative, 'available', lambda: False)
    hidden = {'cv2': [], 'PIL': ['cv2'], 'numpy': ['cv2', 'PIL']}[backend]
    for mod in hidden:
        monkeypatch.setitem(sys.modules, mod, None)   # import raises
    img = (np.random.RandomState(9).rand(120, 200, 3) * 255).astype(np.uint8)
    canvas, scale = det._host_letterbox(img)
    jcanvas, jscale = jdet._host_letterbox(img)
    np.testing.assert_array_equal(canvas, jcanvas)
    assert scale == jscale
    usable = backend != 'numpy'
    assert det._host_letterbox_available() == usable
    assert jdet._host_letterbox_available() == usable
    if usable:
        for d in (jdet, det):
            d.config = dataclasses.replace(d.config, host_preprocess='auto')
        assert_detections_agree(det.detect(img), jdet.detect(img))


def test_preprocess_image(default_pair, tmp_path):
    from PIL import Image
    jdet, det = default_pair
    img = (np.random.RandomState(6).rand(50, 70, 3) * 255).astype(np.uint8)
    path = str(tmp_path / 'f.png')
    Image.fromarray(img).save(path)
    x, orig, scale = det.preprocess_image(path)
    jx, jorig, jscale = jdet.preprocess_image(path)
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(orig, img)
    assert scale == jscale == min(SIZE / 50, SIZE / 70)


def test_draw_detections(pair):
    _, det, _, _ = pair
    img = (np.random.RandomState(4).rand(80, 100, 3) * 255).astype(np.uint8)
    drawn = det.draw_detections(img, det.detect(img))
    assert drawn.shape == img.shape and drawn.dtype == np.uint8


def test_unported_paths_raise(pair, weights, tower_npz, tmp_path):
    """Orbax checkpoints still raise; host_preprocess=True and
    quant='int8', once refused here, now run (an int8 config from a seed:
    random float layers, untrained int8 blocks)."""
    _, det, cfg, path = pair
    host = InferenceConfig(model=cfg.model, host_preprocess=True,
                           conf_threshold=-1.0, nms_topk=16,
                           max_detections=4)
    hdet = YOLOCLIPDetector(host, vocab_path=path, state_dict=weights[3],
                            text_checkpoint=tower_npz, device='cpu')
    img = (np.random.RandomState(8).rand(40, 90, 3) * 255).astype(np.uint8)
    got = hdet.detect(img)
    assert 0 < len(got) <= 4
    assert all(0 <= d['box'][0] <= d['box'][2] <= 90
               and 0 <= d['box'][1] <= d['box'][3] <= 40 for d in got)
    int8 = InferenceConfig(model=ModelConfig(image_size=(SIZE, SIZE),
                                             quant='int8'),
                           conf_threshold=-1.0, nms_topk=16,
                           max_detections=4)
    qdet = YOLOCLIPDetector(int8, vocab_path=path, device='cpu')
    got = qdet.detect(img)
    assert 0 < len(got) <= 4 and all(np.isfinite(d['score']) for d in got)
    with pytest.raises(NotImplementedError,
                       match='tools/orbax_to_torch.py --text'):   # orbax dir
        YOLOCLIPDetector(cfg, vocab_path=path, text_checkpoint=str(tmp_path),
                         device='cpu')


def test_class_names_vocabulary_matches_jax(prompt_pair):
    jdet, det = prompt_pair
    assert det.class_names == jdet.class_names == NAMES
    assert det.use_offline_vocab and not det.text_encoder.random_init
    np.testing.assert_allclose(det.offline_vocabulary.numpy(),
                               np.asarray(jdet.offline_vocabulary), rtol=0,
                               atol=1e-5)


def test_detect_batch_class_names_and_prompts_match_jax(prompt_pair):
    jdet, det = prompt_pair
    imgs = (np.random.RandomState(12).rand(2, 100, 140, 3) * 255).astype(
        np.uint8)
    assert_batches_agree(det.detect_batch(imgs), jdet.detect_batch(imgs))
    assert_batches_agree(det.detect_batch(imgs, text_prompts=PROMPTS),
                         jdet.detect_batch(imgs, text_prompts=PROMPTS))


def test_detect_with_text_prompts_matches_jax(prompt_pair):
    jdet, det = prompt_pair
    img = (np.random.RandomState(5).rand(110, 180, 3) * 255).astype(np.uint8)
    got = det.detect(img, text_prompts=PROMPTS)
    assert_detections_agree(got, jdet.detect(img, text_prompts=PROMPTS))
    assert {d['class_name'] for d in got} <= set(PROMPTS)
    assert set(det.text_encoder._cache) >= set(PROMPTS)   # encoded once


def test_online_mode_needs_prompts(weights, tmp_path):
    _, cfg, _, sd = weights
    online = InferenceConfig(model=cfg.model, use_offline_vocab=False,
                             host_preprocess=False)
    tower = tmp_path / 'tower.pth'
    tiny = CLIPTextTransformer(width=64, layers=1)
    init_text_weights(tiny, torch.Generator().manual_seed(0))
    torch.save(tiny.state_dict(), tower)
    det = YOLOCLIPDetector(online, text_checkpoint=str(tower), state_dict=sd,
                           device='cpu')
    assert det.offline_vocabulary is None and not det.use_offline_vocab
    img = np.zeros((64, 64, 3), np.uint8)
    with pytest.raises(ValueError, match='online mode'):
        det.detect(img)
    assert isinstance(det.detect(img, text_prompts=['a cat']), list)
    strict = InferenceConfig(model=cfg.model, require_text_quality=True,
                             host_preprocess=False)
    with pytest.raises(RuntimeError, match='DEGRADED'):
        YOLOCLIPDetector(strict, vocab_path=None, state_dict=sd,
                         text_checkpoint=str(tower), device='cpu')
