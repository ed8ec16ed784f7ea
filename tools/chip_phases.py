#!/usr/bin/env python3
"""Some of chip_smoke.py's parallel phases alone, on a machine with the
GPU, from the repository root:

    python3 tools/chip_phases.py                    # ddp_graphs
    python3 tools/chip_phases.py ddp_graphs ddp tp_train multihost
    python3 tools/chip_phases.py split ckpt_async

Builds the kernels, then runs each named phase (`[ddp graphs]`, `[ddp]`,
`[tp train]`, `[multihost 4x2]`, `[split ranks]`, `[ckpt async]`) and its
seconds. The phases spawn their ranks with torch.multiprocessing 'spawn',
whose children import this file again: hence a file with a `__main__`
guard, not `python -c`. On several cards `[ddp graphs]` and `[split
ranks]` also run one NCCL rank a card. `[split ranks]` serves the COCO-80
JSON vocabulary of chip_smoke.py and 1203 seeded unit rows for LVIS
(chip_smoke.py builds those through the text tower). Exits non-zero if a
phase fails.
"""

import json
import os
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as c  # noqa: E402

PHASES = ('ddp_graphs', 'ddp', 'tp_train', 'multihost', 'split',
          'ckpt_async')


def _lvis_vocab(path: str) -> None:
    rows = torch.randn((c.LVIS_C, c.EMBED),
                       generator=torch.Generator().manual_seed(0))
    rows = rows / rows.norm(dim=-1, keepdim=True)
    with open(path, 'w') as f:
        json.dump({n: r.tolist() for n, r in zip(c.LVIS_NAMES, rows)}, f)


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
            elif name == 'multihost':
                c.phase_multihost(tmp, card)
            elif name == 'ckpt_async':
                c.phase_ckpt_async(tmp, card)
            else:
                coco, lvis = (os.path.join(tmp, f) for f in ('coco.json',
                                                             'lvis.json'))
                c._write_vocab(coco)
                _lvis_vocab(lvis)
                print(c.phase_split_ranks(sim, nms, coco, lvis,
                                          c._smoke_frames('cuda'), tmp,
                                          card))
            print(f'[{name}] phase seconds {time.perf_counter() - t0:.1f}  '
                  f'[{card}]', flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
