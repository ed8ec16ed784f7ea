"""The port's `inference/streaming.py::StreamingDetector` on the CPU: one
`step` against JAX `StreamingDetector.step` (2 streams, variant 'n',
128 px, the same JAX random-init weights and numpy frames), then the
pipelined `run`'s ordering and stats; and one `step` of a detector's
int8 deploy graph (`quantize_int8`, also with the uint8 space-to-depth
stem) against that detector's `detect_batch` on the same frames.

Tolerances: counts, validity, saturation flags and class ids exact;
scores atol 1e-5; boxes (rescaled and clipped to the frame) atol 1e-3 px.
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
from yoloclip_tpu.inference.streaming import (
    StreamingDetector as JaxStreamingDetector)
from yoloclip_tpu.models.yolo_clip import YOLOCLIP as JaxYOLOCLIP
from yoloclip_tpu_torch.config import InferenceConfig, ModelConfig
from yoloclip_tpu_torch.inference.detector import YOLOCLIPDetector
from yoloclip_tpu_torch.inference.streaming import StreamingDetector
from yoloclip_tpu_torch.models.yolo_clip import build_model
from yoloclip_tpu_torch.utils.convert import state_dict_from_jax

torch.set_num_threads(2)

SIZE, HW = 128, (96, 160)
SETTINGS = dict(conf_threshold=0.0, nms_topk=32, max_detections=8)


@pytest.fixture(scope='module')
def setup():
    jcfg = JaxInferenceConfig(model=JaxModelConfig(image_size=(SIZE, SIZE)),
                              **SETTINGS)
    cfg = InferenceConfig(model=ModelConfig(image_size=(SIZE, SIZE)),
                          **SETTINGS)
    variables = jax.jit(JaxYOLOCLIP(jcfg.model).init)(
        jax.random.PRNGKey(4), jnp.zeros((1, SIZE, SIZE, 3)),
        jnp.zeros((3, 512)))
    model = build_model(cfg.model, state_dict_from_jax(variables, cfg.model))
    text = np.random.RandomState(1).randn(3, 512).astype(np.float32)
    text /= np.linalg.norm(text, axis=-1, keepdims=True)
    return jcfg, cfg, variables, model, text


def frames(seed, n=2):
    return (np.random.RandomState(seed).rand(n, *HW, 3) * 255).astype(
        np.uint8)


def test_step_matches_jax(setup):
    jcfg, cfg, variables, model, text = setup
    jsd = JaxStreamingDetector(variables, jnp.asarray(text), 2, HW, jcfg)
    sd = StreamingDetector(model, torch.from_numpy(text), 2, HW, cfg,
                           device='cpu')
    f = frames(0)
    want, got = jsd.step(f), sd.step(f)
    assert set(got) == set(want)
    for k in ('count', 'valid', 'prefilter_saturated', 'class_ids'):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    np.testing.assert_allclose(got['scores'].numpy(),
                               np.asarray(want['scores']), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got['boxes'].numpy(),
                               np.asarray(want['boxes']), rtol=0, atol=1e-3)
    assert got['boxes'].shape == (2, 8, 4) and (got['count'] > 0).all()
    b = got['boxes'].numpy()
    assert b.min() >= 0 and b[..., 0::2].max() <= HW[1] \
        and b[..., 1::2].max() <= HW[0]


def test_run_pipelined_in_order(setup):
    _, cfg, _, model, text = setup
    sd = StreamingDetector(model, torch.from_numpy(text), 2, HW, cfg,
                           device='cpu')
    results = []
    stats = sd.run(lambda k: frames(10 + k),
                   lambda k, out: results.append((k, out)), max_steps=4)
    assert stats['steps'] == 4 and stats['mean_step_ms'] > 0
    assert stats['fps_per_stream'] == pytest.approx(
        1000.0 / stats['mean_step_ms'])
    assert [k for k, _ in results] == [0, 1, 2, 3]
    for k, out in results:
        assert isinstance(out['boxes'], np.ndarray)
        assert out['boxes'].shape == (2, 8, 4)
        want = sd.step(frames(10 + k))
        np.testing.assert_array_equal(out['count'], want['count'].numpy())
        np.testing.assert_array_equal(out['scores'], want['scores'].numpy())
    # a source that ends early stops the loop
    stats = sd.run(lambda k: frames(k) if k < 2 else None,
                   lambda k, out: None, max_steps=10)
    assert stats['steps'] == 2


def test_mesh_not_ported(setup):
    """A mesh with a 'model' axis: streams split over its data axis only
    (the JAX streaming detector shards frames over 'data'), so a 1x2 mesh
    runs one replica and gives the detector's detections."""
    from yoloclip_tpu_torch.parallel.mesh import create_mesh
    _, cfg, _, model, text = setup
    mesh = create_mesh(n_data=1, n_model=2, devices=['cpu'] * 2)
    assert mesh.shape == {'data': 1, 'model': 2}
    f = frames(8, n=2)
    want = StreamingDetector(model, text, 2, HW, cfg, device='cpu').step(f)
    sd = StreamingDetector(model, text, 2, HW, cfg, device='cpu', mesh=mesh)
    assert len(sd._replicas) == 1
    got = sd.step(f)
    for k in ('count', 'valid', 'class_ids'):
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), k)
    np.testing.assert_allclose(got['scores'].numpy(), want['scores'].numpy(),
                               rtol=0, atol=1e-5)


def test_step_over_mesh_matches_single_device(setup):
    """Four streams over two CPU replicas (two streams each) against the
    detector without a mesh, on the same frames; streams that do not
    divide over the axis are refused."""
    from yoloclip_tpu_torch.parallel.mesh import create_mesh
    _, cfg, _, model, text = setup
    mesh = create_mesh(n_data=2, devices=['cpu', 'cpu'])
    f = frames(9, n=4)
    want = StreamingDetector(model, text, 4, HW, cfg, device='cpu').step(f)
    sd = StreamingDetector(model, text, 4, HW, cfg, device='cpu', mesh=mesh)
    got = sd.step(f)
    assert sd._replicas[1][0] is not model
    for k in ('count', 'valid', 'class_ids', 'prefilter_saturated'):
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), k)
    np.testing.assert_allclose(got['scores'].numpy(), want['scores'].numpy(),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got['boxes'].numpy(), want['boxes'].numpy(),
                               rtol=0, atol=1e-3)
    with pytest.raises(ValueError, match='divide evenly'):
        StreamingDetector(model, text, 3, HW, cfg, device='cpu', mesh=mesh)


@pytest.mark.parametrize('stem_u8_s2d', [False, True])
def test_step_int8_matches_detect_batch(setup, tmp_path, stem_u8_s2d):
    """A quantized detector's model and vocabulary behind one streaming
    step give exactly its detect_batch on the same frames (both run the
    same CPU ops); under stem_u8_s2d both letterbox to the uint8
    space-to-depth canvas."""
    _, cfg, variables, _, text = setup
    path = str(tmp_path / 'vocab.json')
    with open(path, 'w') as f:
        json.dump({n: v.tolist() for n, v in zip('abc', text)}, f)
    icfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, stem_u8_s2d=stem_u8_s2d))
    det = YOLOCLIPDetector(icfg, vocab_path=path, device='cpu',
                           state_dict=state_dict_from_jax(variables,
                                                          cfg.model))
    det.quantize_int8(frames(20))
    sd = StreamingDetector(det.model, det.offline_vocabulary, 2, HW,
                           det.config, device='cpu')
    f = frames(21)
    got, want = sd.step(f), det.detect_batch(f)
    assert det.config.model.quant == 'int8' and set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert (got['count'] > 0).all()
