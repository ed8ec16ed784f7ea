"""The port must run where JAX is not installed (the GPU machine has none).

In a fresh interpreter: import every `yoloclip_tpu_torch` module, run a
tiny CPU `detect_batch`, then check that neither jax, jaxlib nor flax was
imported, and that nothing of the JAX package beyond its jax-free modules
was.
"""

import json
import os
import subprocess
import sys

import torch

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALLOWED = {'yoloclip_tpu', 'yoloclip_tpu.config', 'yoloclip_tpu.utils',
           'yoloclip_tpu.utils.convert', 'yoloclip_tpu.utils.visualize'}

SCRIPT = r'''
import importlib, json, os, pkgutil, sys
import numpy as np
import torch
torch.set_num_threads(2)
import yoloclip_tpu_torch
for info in pkgutil.walk_packages(yoloclip_tpu_torch.__path__,
                                  'yoloclip_tpu_torch.'):
    importlib.import_module(info.name)
from yoloclip_tpu.config import InferenceConfig, ModelConfig
from yoloclip_tpu_torch.inference.detector import YOLOCLIPDetector
path = os.path.join(sys.argv[1], 'vocab.json')
rng = np.random.RandomState(0)
with open(path, 'w') as f:
    json.dump({n: rng.randn(512).tolist() for n in ('a', 'b', 'c')}, f)
cfg = InferenceConfig(model=ModelConfig(image_size=(64, 64)),
                      conf_threshold=-1.0, nms_topk=32, max_detections=8,
                      host_preprocess=False)
det = YOLOCLIPDetector(cfg, vocab_path=path, device='cpu', seed=0)
out = det.detect_batch(np.zeros((1, 48, 64, 3), np.uint8))
assert out['boxes'].shape == (1, 8, 4) and int(out['count'][0]) > 0
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
