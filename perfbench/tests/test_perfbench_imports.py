"""What a run loads: no JAX and no JAX package anywhere; nothing of the
system under test in the reference. Checked in fresh interpreters, by
whole top-level module names (the system's name begins with the JAX
package's)."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FORBIDDEN = {'jax', 'jaxlib', 'flax', 'yoloclip_tpu'}

DRY_RUN = r'''
import json, sys, time
sys.path.insert(0, sys.argv[1])
import torch
torch.set_num_threads(2)
from perfbench.tests import small
for w in ('n-coco80-batch32', 'l-lvis1203-batch32-720p'):
    small.run(w, seconds=1.5, trace=True)
print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))
'''

REFERENCE = r'''
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
from perfbench.reference import letterbox, model
from perfbench.lib import check, judge, roofline, trace, traffic
from perfbench.lib import weights
sd = weights.seeded_state_dict(model.state_shapes('n'), 1, 'cpu')
m = model.YOLOCLIPReference('n')
m.load_state_dict(sd)
m.eval()
with torch.no_grad():
    m(torch.rand(1, 3, 64, 64), torch.rand(3, 512))
roofline.model_flops_per_image('n', 3, (64, 64))
print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))
'''


def _modules(script):
    out = subprocess.run([sys.executable, '-c', script, ROOT],
                         capture_output=True, text=True, timeout=600,
                         cwd=ROOT, env={**os.environ, 'USE_FLAX': '0'})
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_dry_run_loads_no_jax():
    mods = _modules(DRY_RUN)
    assert 'yoloclip_tpu_torch' in mods       # the system under test ran
    assert not mods & FORBIDDEN, mods & FORBIDDEN


def test_the_reference_loads_nothing_of_the_system():
    mods = _modules(REFERENCE)
    assert not mods & (FORBIDDEN | {'yoloclip_tpu_torch'})
