#!/usr/bin/env python3
"""Some of chip_smoke.py's parallel phases alone, on a machine with the
GPU, from the repository root:

    python3 tools/chip_phases.py                    # ddp_graphs
    python3 tools/chip_phases.py ddp_graphs ddp tp_train multihost

Builds the kernels, then runs each named phase (`[ddp graphs]`, `[ddp]`,
`[tp train]`, `[multihost 4x2]`) and its seconds. The phases spawn their
ranks with torch.multiprocessing 'spawn', whose children import this
file again: hence a file with a `__main__` guard, not `python -c`. On
four cards `[ddp graphs]` also runs one NCCL rank a card. Exits non-zero
if a phase fails.
"""

import os
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as c  # noqa: E402

PHASES = ('ddp_graphs', 'ddp', 'tp_train', 'multihost')


def main() -> int:
    which = sys.argv[1:] or ['ddp_graphs']
    unknown = sorted(set(which) - set(PHASES))
    if unknown:
        print(f'unknown phases {unknown}; choose from {PHASES}',
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print('chip_phases: needs an NVIDIA GPU', file=sys.stderr)
        return 1
    from yoloclip_tpu_torch import _build
    from yoloclip_tpu_torch.ops.kernels import nms, similarity as sim
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = c.phase_device()
    _build.build_all()
    with tempfile.TemporaryDirectory() as tmp:
        for name in which:
            t0 = time.perf_counter()
            if name == 'ddp_graphs':
                print(c.phase_ddp_graphs(sim, nms, tmp, card))
            elif name == 'ddp':
                print(c.phase_ddp(sim, nms, tmp, card))
            elif name == 'tp_train':
                c.phase_tp_train(tmp, card)
            else:
                c.phase_multihost(tmp, card)
            print(f'[{name}] phase seconds {time.perf_counter() - t0:.1f}  '
                  f'[{card}]', flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
