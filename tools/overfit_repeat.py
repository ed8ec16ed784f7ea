"""Repeat `chip_smoke.py`'s overfit twin on the GPU to see whether its
outcome holds from run to run.

Each run trains the twin from the same seeded weights
(`chip_smoke.train_overfit`: 4 images of one white square, 128 px, bs=4)
and serves the checkpoint at conf 0.02, so the boxes just below the
phase's 0.25 show too. A run prints its final loss, the sum of its
parameters (equal bit for bit between runs only where the training is
deterministic) and, for each image, the number of boxes at 0.25 or more
with the first five boxes' score, class and IoU with the square:

    python tools/overfit_repeat.py --runs 8 --steps 120 --free
    python tools/overfit_repeat.py --runs 3

--free trains with the card's default (nondeterministic) reductions; by
default the run is deterministic, as the phase trains.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
from typing import List, Optional

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--runs', type=int, default=3)
    ap.add_argument('--steps', type=int, default=120,
                    help='steps after the first (the phase: 120)')
    ap.add_argument('--free', action='store_true',
                    help='train with the default, nondeterministic '
                         'reductions')
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print('overfit_repeat: needs an NVIDIA GPU', file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as c
    from yoloclip_tpu_torch import _build
    from yoloclip_tpu_torch.ops.boxes import pairwise_iou
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()
    failed = 0
    with tempfile.TemporaryDirectory() as tmp:
        for r in range(args.runs):
            run = c.train_overfit(tmp, args.steps, not args.free)
            img, boxes = run['img'], run['boxes']
            out = c.overfit_detector(run, 0.02).detect_batch(
                torch.from_numpy((img * 255).astype(np.uint8)).cuda())
            rows, ok = [], True
            for b in range(len(img)):
                n = int(out['count'][b])
                sc = out['scores'][b][:n].float().cpu().numpy()
                cl = out['class_ids'][b][:n].cpu().numpy()
                iou = pairwise_iou(out['boxes'][b][:n].float().cpu(),
                                   torch.from_numpy(boxes[b, :1]))[:, 0]
                above = int((sc >= 0.25).sum())
                ok &= above == 1 and n > 0 and cl[0] == 0
                rows.append(f'image {b}: {above} at >= 0.25; ' + ' '.join(
                    f'{s:.3f}/c{k}/IoU {u:.2f}'
                    for s, k, u in zip(sc[:5], cl[:5], iou[:5].numpy())))
            failed += not ok
            print(f'[overfit repeat] run {r}: {args.steps + 1} steps, '
                  f'{"free" if args.free else "deterministic"}, '
                  f'{run["secs"]:.1f} s, loss {run["last"]:.6f}, parameter '
                  f'sum {run["digest"]:.9e}, {"pass" if ok else "FAIL"}\n  '
                  + '\n  '.join(rows), flush=True)
    print(f'[overfit repeat] {failed} of {args.runs} runs would fail the '
          f'phase (not exactly one class-0 box at >= 0.25 in each image)')
    return 0


if __name__ == '__main__':
    sys.exit(main())
