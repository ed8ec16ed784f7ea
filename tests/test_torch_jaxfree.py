"""The port must run where JAX is not installed (the GPU machine has none).

In a fresh interpreter: import every `yoloclip_tpu_torch` module, run a
tiny CPU `detect_batch` from a JSON vocabulary, print `cli.export`'s help,
export that detector (`utils/export.py`) and run the artifact, build a
detector from class names with a miniature text tower and run `detect`
with free-text prompts,
serve one request through a `DetectionServer` (the native host letterbox)
and close it, run one `StreamingDetector.step`, quantize the detector to
the int8 deploy graph (`quantize_int8`) and run a `detect_batch`, take
one training step and one `evaluate` (with NMS) through YOLOCLIPTrainer on
a synthetic batch, serve and stream over a mesh of two CPU replicas
(`parallel/`), run the classes split over a 1x2 mesh and a frame's height
split 2-way (`parallel/spatial.py`, the detector and the server), trace
a `detect_batch` and take its spans (`utils/profiling.py`,
`utils/general.py`), then check that neither
jax, jaxlib, flax nor any module of the JAX package (`yoloclip_tpu`) was
imported.

`tools/` is outside the scan: its converter (`tools/orbax_to_torch.py`)
reads JAX orbax checkpoints, so it imports JAX and the JAX package by
design and runs where JAX is installed, never as part of the port.
"""

import json
import os
import subprocess
import sys

import torch

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALLOWED = set()

SCRIPT = r'''
import importlib, json, os, pkgutil, sys
import numpy as np
import torch
torch.set_num_threads(2)
import yoloclip_tpu_torch
for info in pkgutil.walk_packages(yoloclip_tpu_torch.__path__,
                                  'yoloclip_tpu_torch.'):
    importlib.import_module(info.name)
from yoloclip_tpu_torch.config import InferenceConfig, ModelConfig
from yoloclip_tpu_torch.inference.detector import YOLOCLIPDetector
from yoloclip_tpu_torch.text.model import (CLIPTextTransformer,
                                           init_text_weights)
tower = os.path.join(sys.argv[1], 'tower.pth')
tiny = CLIPTextTransformer(width=64, layers=2)
init_text_weights(tiny, torch.Generator().manual_seed(0))
torch.save(tiny.state_dict(), tower)
path = os.path.join(sys.argv[1], 'vocab.json')
rng = np.random.RandomState(0)
with open(path, 'w') as f:
    json.dump({n: rng.randn(512).tolist() for n in ('a', 'b', 'c')}, f)
cfg = InferenceConfig(model=ModelConfig(image_size=(64, 64)),
                      conf_threshold=-1.0, nms_topk=32, max_detections=8,
                      host_preprocess=False)
det = YOLOCLIPDetector(cfg, vocab_path=path, text_checkpoint=tower,
                       device='cpu', seed=0)
out = det.detect_batch(np.zeros((1, 48, 64, 3), np.uint8))
assert out['boxes'].shape == (1, 8, 4) and int(out['count'][0]) > 0
from yoloclip_tpu_torch.cli.export import main as export_main
try:
    export_main(['--device', 'cpu', '--help'])
except SystemExit as e:
    assert e.code == 0
from yoloclip_tpu_torch.utils.export import export_detector, load_exported
art = export_detector(det.model, det.offline_vocabulary, (1, 64, 64),
                      os.path.join(sys.argv[1], 'det.pt2'),
                      conf_threshold=-1.0, nms_topk=32, max_detections=8)
got = load_exported(art, device='cpu')(torch.rand(1, 64, 64, 3))
assert got['boxes'].shape == (1, 8, 4) and int(got['count'][0]) > 0
det = YOLOCLIPDetector(cfg, class_names=['cat', 'dog'], text_checkpoint=tower,
                       device='cpu', seed=0)
dets = det.detect(np.zeros((48, 64, 3), np.uint8),
                  text_prompts=['a red car', 'café'])
assert dets and {d['class_name'] for d in dets} <= {'a red car', 'café'}
from yoloclip_tpu_torch import native
from yoloclip_tpu_torch.inference.server import DetectionServer
from yoloclip_tpu_torch.inference.streaming import StreamingDetector
assert native.available()
srv = DetectionServer(det, max_batch=2, max_delay_ms=1.0)
try:
    got = srv.detect(np.zeros((30, 50, 3), np.uint8), timeout=120)
finally:
    srv.close()
assert got and {d['class_name'] for d in got} <= {'cat', 'dog'}
sd = StreamingDetector(det.model, det.offline_vocabulary, 2, (48, 64), cfg,
                       device='cpu')
out = sd.step(np.zeros((2, 48, 64, 3), np.uint8))
assert out['boxes'].shape == (2, 8, 4) and bool((out['count'] > 0).all())
det.quantize_int8(np.random.RandomState(1).randint(0, 256, (2, 48, 64, 3),
                                                   dtype=np.uint8))
out = det.detect_batch(np.zeros((2, 48, 64, 3), np.uint8))
assert det.config.model.quant == 'int8' and out['boxes'].shape == (2, 8, 4)
from yoloclip_tpu_torch.config import TrainingConfig
from yoloclip_tpu_torch.data.synth import make_synth_detection_set
from yoloclip_tpu_torch.models.yolo_clip import YOLOCLIP, init_weights
from yoloclip_tpu_torch.train.trainer import YOLOCLIPTrainer
tcfg = TrainingConfig(model=ModelConfig(image_size=(64, 64)), max_objects=8,
                      output_dir=os.path.join(sys.argv[1], 'run'),
                      eval_with_nms=True, ema_decay=0.9)
model = YOLOCLIP(tcfg.model)
init_weights(model, torch.Generator().manual_seed(0))
trainer = YOLOCLIPTrainer(model, det.text_encoder, tcfg, device='cpu')
batch = make_synth_detection_set(2, 0, image_size=64, max_objects=8,
                                 min_side=8, max_side=24)
batch['text_prompts'] = [['a cat', 'a dog']] * 2
batch['class_ids'] %= 2
losses = trainer.train_epoch([batch], 1)
metrics = trainer.evaluate([batch])
assert trainer.state.step == 1 and np.isfinite(losses['loss'])
assert np.isfinite(metrics['loss']) and 'mAP50' in metrics
from yoloclip_tpu_torch.parallel import multihost
from yoloclip_tpu_torch.parallel.mesh import create_mesh
from yoloclip_tpu_torch.utils.general import Timer
from yoloclip_tpu_torch.utils import profiling
assert multihost.process_local_indices(5, 1, 2) == [1, 3]
mesh = create_mesh(n_data=2, devices=['cpu', 'cpu'])
srv = DetectionServer(det, max_batch=2, max_delay_ms=1.0, mesh=mesh)
try:
    assert srv.detect(np.zeros((30, 50, 3), np.uint8), timeout=120)
finally:
    srv.close()
sd = StreamingDetector(det.model, det.offline_vocabulary, 2, (48, 64), cfg,
                       device='cpu', mesh=mesh)
assert sd.step(np.zeros((2, 48, 64, 3), np.uint8))['boxes'].shape[0] == 2
from yoloclip_tpu_torch.parallel.spatial import spatialize_detector
from yoloclip_tpu_torch.parallel.train_step import make_sharded_inference
mesh2 = create_mesh(n_data=1, n_model=2, devices=['cpu', 'cpu'])
(o,) = make_sharded_inference(det.model, mesh2)(
    torch.zeros((1, 64, 64, 3)), det.offline_vocabulary)
assert o['class_ids'].shape == (1, 84)
srv = DetectionServer(det, max_batch=1, max_delay_ms=1.0, mesh=mesh2,
                      spatial=True)
try:
    assert srv.detect(np.zeros((30, 50, 3), np.uint8), timeout=120)
finally:
    srv.close()
spatialize_detector(det, mesh2)
assert det.detect(np.zeros((30, 50, 3), np.uint8))
profiling.enable(True)
with Timer() as t, profiling.trace(os.path.join(sys.argv[1], 'trace')):
    det.detect_batch(np.zeros((2, 48, 64, 3), np.uint8))
got = profiling.take()
assert t.elapsed > 0
assert [s['name'] for s in got['spans']].count('yoloclip.detect_batch') == 1
assert os.path.isfile(os.path.join(sys.argv[1], 'trace', 'trace.json'))
print(json.dumps(sorted(m for m in sys.modules
                        if m.split('.')[0] in ('jax', 'jaxlib', 'flax',
                                               'yoloclip_tpu'))))
'''


def test_port_never_imports_jax(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, '-c', SCRIPT, str(tmp_path)],
                          capture_output=True, text=True, timeout=300,
                          cwd=REPO, env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    loaded = set(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert not {m for m in loaded if not m.startswith('yoloclip_tpu')}
    assert loaded <= ALLOWED, sorted(loaded - ALLOWED)
