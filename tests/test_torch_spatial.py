"""The port's spatially partitioned inference (`parallel/spatial.py`, the
server's `spatial=`) on the CPU against the JAX package's spatialized
detector (tests/test_spatial.py, tests/test_server.py's spatial cases).

Both detectors load the same JAX random-init weights (the port through
`state_dict_from_jax`) and serve the same JSON vocabulary at 160 px; the
JAX one runs on the 8-device virtual CPU mesh, the port over an
in-process 2x2 mesh of the CPU (one thread a shard, the halo rows
exchanged through `collectives.LocalGroup`). Tolerances are the JAX
tests': class ids and counts exact, scores 1e-4, boxes 1 px for
`detect()` and the server (int boxes), 0.5 px for `detect_batch()`.

The int8 deploy graph and the space-to-depth stems under a height split
against the same detector unsplit: ids exact, boxes 1e-3 px (+1e-4
relative), scores 1e-5; in int8 at tests/test_quantize.py's bounds for
sharded int8 inference (scores 2e-3 + 1e-3 relative): the float convs
around the int8 ones run other row counts, whose last-ulp differences flip
an activation's int8 rounding now and then (measured 7.7e-4 in a score).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from yoloclip_tpu.config import InferenceConfig as JaxInferenceConfig
from yoloclip_tpu.config import ModelConfig as JaxModelConfig
from yoloclip_tpu.inference.detector import YOLOCLIPDetector as JaxDetector
from yoloclip_tpu.models.yolo_clip import YOLOCLIP as JaxYOLOCLIP
from yoloclip_tpu.parallel.mesh import create_mesh as jax_create_mesh
from yoloclip_tpu.parallel.spatial import (canvas_sharding as
                                           jax_canvas_sharding,
                                           spatialize_detector as
                                           jax_spatialize)
from yoloclip_tpu.text.encoder import save_text_tower_params
from yoloclip_tpu.text.model import CLIPTextTransformer as JaxTower
from yoloclip_tpu_torch.config import InferenceConfig, ModelConfig
from yoloclip_tpu_torch.inference.detector import YOLOCLIPDetector
from yoloclip_tpu_torch.inference.server import DetectionServer
from yoloclip_tpu_torch.parallel.mesh import create_mesh
from yoloclip_tpu_torch.parallel.spatial import (canvas_sharding,
                                                 row_blocks,
                                                 spatialize_detector)
from yoloclip_tpu_torch.utils.convert import state_dict_from_jax

torch.set_num_threads(2)

SIZE = 160
NAMES = ['cat', 'dog', 'person']


def _mesh():
    return create_mesh(n_data=2, n_model=2, devices=['cpu'] * 4)


def _img(seed, h, w):
    return (np.random.RandomState(seed).rand(h, w, 3) * 255).astype(np.uint8)


@pytest.fixture(scope='module')
def files(tmp_path_factory):
    """The shared weights, JSON vocabulary and miniature text tower."""
    tmp = tmp_path_factory.mktemp('spatial')
    jcfg = JaxModelConfig(image_size=(SIZE, SIZE))
    variables = jax.jit(JaxYOLOCLIP(jcfg).init)(
        jax.random.PRNGKey(1), jnp.zeros((1, SIZE, SIZE, 3)),
        jnp.zeros((4, 512)))
    rng = np.random.RandomState(0)
    vocab = rng.randn(len(NAMES), 512)
    vocab /= np.linalg.norm(vocab, axis=-1, keepdims=True)
    path = str(tmp / 'vocab.json')
    with open(path, 'w') as f:
        json.dump({n: v.tolist() for n, v in zip(NAMES, vocab)}, f)
    params = JaxTower(width=64, layers=1, heads=1, output_dim=512).init(
        jax.random.PRNGKey(2), jnp.zeros((1, 77), jnp.int32))['params']
    npz = str(tmp / 'tower.npz')
    save_text_tower_params(jax.tree_util.tree_map(np.asarray, params), npz)
    return variables, path, npz


def _config(cls, mcls, **model_kw):
    return cls(model=mcls(image_size=(SIZE, SIZE), **model_kw),
               conf_threshold=-10.0, nms_topk=64, max_detections=16)


@pytest.fixture(scope='module')
def jdet(files):
    variables, path, npz = files
    return JaxDetector(vocab_path=path, variables=variables,
                       text_checkpoint=npz,
                       config=_config(JaxInferenceConfig, JaxModelConfig))


def _port(files, **model_kw):
    variables, path, npz = files
    cfg = _config(InferenceConfig, ModelConfig, **model_kw)
    return YOLOCLIPDetector(cfg, vocab_path=path, text_checkpoint=npz,
                            state_dict=state_dict_from_jax(variables,
                                                           cfg.model),
                            device='cpu')


@pytest.fixture(scope='module')
def det(files):
    return _port(files)


def _same_dets(got, want, box_tol=1):
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert a['class_id'] == b['class_id']
        assert a['score'] == pytest.approx(b['score'], abs=1e-4)
        np.testing.assert_allclose(a['box'], b['box'], atol=box_tol)


def test_canvas_sharding_specs():
    """The port's layouts read as the JAX PartitionSpecs."""
    jm, m = jax_create_mesh(n_data=2, n_model=2), _mesh()
    for kw in ({}, {'batch_axis': 'data', 'height_axis': 'model'}):
        assert canvas_sharding(m, **kw).spec == tuple(
            jax_canvas_sharding(jm, **kw).spec)
    assert canvas_sharding(m).layout()[:2] == (1, 4)
    assert row_blocks(SIZE, 4) == (2, 1, 1, 1)   # uneven shards
    with pytest.raises(ValueError, match='over 6 shards'):
        row_blocks(SIZE, 6)


def test_spatial_detect_matches_jax(jdet, det):
    """detect() through a 4-way height split (both axes folded) against
    JAX's spatialized detect() and the port's unsplit one."""
    img = _img(7, 120, 200)
    base = det.detect(img)
    jax_spatialize(jdet, jax_create_mesh(n_data=2, n_model=2))
    want = jdet.detect(img)
    mesh = _mesh()
    spatialize_detector(det, mesh)
    assert det.spatial_mesh is mesh
    got = det.detect(img)
    _same_dets(got, want)
    _same_dets(got, base)


def test_spatial_detect_batch_matches_jax(jdet, det):
    """detect_batch() with batch over 'data' x height over 'model'."""
    images = (np.random.RandomState(11).rand(4, SIZE, SIZE, 3)
              * 255).astype(np.uint8)
    jax_spatialize(jdet, jax_create_mesh(n_data=2, n_model=2),
                   batch_axis='data', height_axis='model')
    want = jax.tree_util.tree_map(np.asarray,
                                  dict(jdet.detect_batch(images)))
    spatialize_detector(det, _mesh(), batch_axis='data',
                        height_axis='model')
    got = {k: v.numpy() for k, v in det.detect_batch(images).items()}
    np.testing.assert_array_equal(got['count'], want['count'])
    np.testing.assert_array_equal(got['class_ids'], want['class_ids'])
    np.testing.assert_allclose(got['scores'], want['scores'], atol=1e-4)
    np.testing.assert_allclose(got['boxes'], want['boxes'], atol=0.5)


def test_spatialize_drops_batch_axis_from_height_split(det):
    """The batch axis never reappears in the batched height split; every
    height axis consumed leaves the height unsplit (batch only)."""
    mesh = _mesh()
    spatialize_detector(det, mesh, batch_axis='data',
                        height_axis=('data', 'model'))
    want = canvas_sharding(mesh, batch_axis='data', height_axis='model')
    assert want.spec == ('data', 'model', None, None)
    spatialize_detector(det, mesh, batch_axis='data', height_axis='data')
    out = det.detect_batch(_img(3, SIZE, SIZE)[None].repeat(2, 0))
    assert out['count'].shape[0] == 2


def test_server_spatial_mesh(jdet, det):
    """DetectionServer(spatial=True) over 2x2: batch over 'data' x frame
    height over 'model', against the JAX detector."""
    mesh = create_mesh(n_data=2, n_model=2, devices=['cpu'] * 4)
    det._canvas_model = det._batch_model = None   # the server's own split
    srv = DetectionServer(det, max_batch=4, max_delay_ms=50.0, mesh=mesh,
                          spatial=True)
    try:
        imgs = [_img(i + 20, 100 + 7 * i, 140) for i in range(4)]
        got = [f.result(timeout=300) for f in [srv.submit(im)
                                                for im in imgs]]
        for g, im in zip(got, imgs):
            w = jdet.detect(im)
            assert len(g) == len(w)
            for a, b in zip(g, w):
                assert a['class_id'] == b['class_id']
                np.testing.assert_allclose(a['score'], b['score'],
                                           rtol=1e-4, atol=1e-5)
                assert np.abs(np.array(a['box'])
                              - np.array(b['box'])).max() <= 1
    finally:
        srv.close()


def test_server_spatial_needs_mesh(det):
    with pytest.raises(ValueError, match='spatial'):
        DetectionServer(det, max_batch=4, spatial=True)


@pytest.mark.parametrize('variant', ['int8', 'stem_s2d', 'stem_u8_s2d'])
def test_spatial_deploy_variants(files, variant):
    """The int8 deploy graph and the space-to-depth stems through the
    height split (4-way detect, data x height detect_batch)."""
    d = _port(files, **({} if variant == 'int8' else {variant: True}))
    frames = (np.random.RandomState(5).rand(4, SIZE, SIZE, 3)
              * 255).astype(np.uint8)
    if variant == 'int8':
        d.quantize_int8(frames)
    want_b = d.detect_batch(frames)
    want = d.detect(frames[0][:120])
    spatialize_detector(d, _mesh(), batch_axis='data', height_axis='model')
    got_b = d.detect_batch(frames)
    spatialize_detector(d, _mesh())
    got = d.detect(frames[0][:120])
    # int8: tests/test_quantize.py's bounds for sharded int8 inference
    tol = (dict(rtol=1e-3, atol=2e-3) if variant == 'int8'
           else dict(rtol=0, atol=1e-5))
    np.testing.assert_array_equal(got_b['class_ids'].numpy(),
                                  want_b['class_ids'].numpy())
    np.testing.assert_allclose(got_b['scores'].numpy(),
                               want_b['scores'].numpy(), **tol)
    np.testing.assert_allclose(got_b['boxes'].numpy(),
                               want_b['boxes'].numpy(), rtol=1e-4,
                               atol=1e-3)
    assert [x['class_id'] for x in got] == [x['class_id'] for x in want]
    np.testing.assert_allclose([x['score'] for x in got],
                               [x['score'] for x in want], **tol)


@pytest.mark.parametrize('shape,size', [((2, 3, 16, 16), (3, 3)),
                                        ((1, 2, 8, 5), (3, 3)),
                                        ((1, 2, 4, 4), (1, 3))])
def test_adaptive_max_pool_deterministic_backward(shape, size):
    """Under torch.use_deterministic_algorithms the I-Pool's adaptive max
    pool (overlapping windows, ties included) takes the index_put_
    backward, with F.adaptive_max_pool2d's output and gradient exactly
    (integer values: every sum is exact)."""
    from yoloclip_tpu_torch.parallel.spatial import _adaptive_max_pool
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.randint(-3, 4, shape).astype(np.float32))
    g = torch.from_numpy(rs.randint(-5, 6, shape[:2] + size)
                         .astype(np.float32))
    xr = x.clone().requires_grad_()
    want = F.adaptive_max_pool2d(xr, size)
    want.backward(g)
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        xd = x.clone().requires_grad_()
        got = _adaptive_max_pool(xd, size)
        assert type(got.grad_fn).__name__ == \
            '_DeterministicAdaptiveMaxPoolBackward'
        got.backward(g)
    finally:
        torch.use_deterministic_algorithms(prev)
    assert torch.equal(got, want)
    assert torch.equal(xd.grad, xr.grad)
    assert type(_adaptive_max_pool(xd, size).grad_fn).__name__ != \
        '_DeterministicAdaptiveMaxPoolBackward'
