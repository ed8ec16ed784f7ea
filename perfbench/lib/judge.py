"""The comparison that decides `correct`.

The system returns, for each image, up to D detections (box, score, class
id) after its NMS. The plain reference (`perfbench/reference/`) gives, for
every anchor of the same image, its box (rescaled and clipped to the
frame) and its cosine against every class. Each returned detection is
matched to the anchor that explains it best: the least box error (as
box_gap below) plus score error (as score_gap below) plus class gap (as
class_gap below), one detection an anchor, the best-explained pairs
first. Anchors in the letterbox's black
border give boxes clipped to the frame's edge that differ by less than
rounding, so a detection alone can point at its neighbour. Each is then
judged by what it says:

  score_gap  |returned score - the reference's cosine of the returned
             class at that anchor|: the backbone, neck, heads and the
             folded similarity kernel's score;
  class_gap  the reference's best cosine at that anchor minus its cosine
             of the returned class: the kernel's class id (0 when they
             agree; a near tie may swap ids by rounding);
  box_gap    the returned box's largest coordinate error against the
             anchor's reference box, over (stride / scale + the box's
             longer side): the box tower, the DFL decode, the rescale and
             the clip;
  nms_violations  a count over the judged images of what no greedy NMS of
             these scores and boxes could give, within the margins below:
             two detections on one anchor; a detection kept under a
             higher kept one that it overlaps by more than the IoU
             threshold; a detection below the confidence threshold; and an
             anchor that greedy NMS had to keep (above the confidence
             threshold, inside the top-k pool and above the last filled
             slot) that no higher kept detection overlaps, but that was not
             returned. This holds the NMS kernel's kept set.

  score_tail_share  the share of all judged detections whose score_gap
             exceeds TAIL_SCORE: how often an answer's score, or its
             class, is off by more than rounding.

Compared with their limits in `LIMITS` (NUMBERS): score_tail_share, the
largest box_gap, and nms_violations summed over the judged images. The
largest score and class gaps are reported beside them, not compared: a
few detections of a sound bf16 run, out of tens of thousands, read as far
off as the control's worst (PERF.md, section 2).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

# Per-number limits (PERF.md, section 2, gives the readings they were set
# from: sound runs of the system over a dozen seeds and more, its int8
# path as the control, and the faults of perfbench/tests).
LIMITS: Dict[str, float] = {
    'score_tail_share': 0.015,
    'box_gap': 0.9,
    'nms_violations': 40,
}
# The score gap above which a detection counts in score_tail_share.
TAIL_SCORE = 0.005
# Margins of the NMS check: a score or an IoU this close to a boundary
# may fall on either side of it by rounding.
SCORE_MARGIN = 0.02
IOU_MARGIN = 0.05

NUMBERS = ('score_tail_share', 'box_gap', 'nms_violations')
GAPS = ('score_gap', 'class_gap', 'box_gap')
VIOLATIONS = ('over_slots', 'same_anchor', 'below_conf', 'overlaps_higher',
              'missed')


def iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU of every box of a (N, 4) with every box of b (M, 4)."""
    a, b = a[:, None, :], b[None, :, :]
    x1 = torch.maximum(a[..., 0], b[..., 0])
    y1 = torch.maximum(a[..., 1], b[..., 1])
    x2 = torch.minimum(a[..., 2], b[..., 2])
    y2 = torch.minimum(a[..., 3], b[..., 3])
    inter = (x2 - x1).clamp_min(0) * (y2 - y1).clamp_min(0)

    def area(x):
        return (x[..., 2] - x[..., 0]) * (x[..., 3] - x[..., 1])
    return inter / (area(a) + area(b) - inter + 1e-7)


def anchor_strides(level_shapes: Sequence[tuple], strides: Sequence[int],
                   device) -> torch.Tensor:
    """(A,) float32: each anchor's stride, level-major."""
    return torch.cat([torch.full((h * w,), float(s), device=device)
                      for (h, w), s in zip(level_shapes, strides)])


def _assign(cost: torch.Tensor, k: int = 32) -> torch.Tensor:
    """(n,) anchor of each detection from the (n, A) cost: the pairs among
    each detection's k cheapest, cheapest first, each anchor taken once; a
    detection whose k are all taken keeps its cheapest."""
    c, cand = cost.topk(min(k, cost.shape[1]), dim=1, largest=False)
    a = cand[:, 0].clone()
    done, used = set(), set()
    order = torch.argsort(c.flatten(), stable=True).tolist()
    cand = cand.flatten().tolist()
    for p in order:
        j, anchor = divmod(p, c.shape[1])[0], cand[p]
        if j in done or anchor in used:
            continue
        a[j] = anchor
        done.add(j)
        used.add(anchor)
    return a


def judge_image(ref_boxes: torch.Tensor, sims: torch.Tensor,
                boxes: torch.Tensor, scores: torch.Tensor,
                class_ids: torch.Tensor, *, slots: int, conf: float,
                iou_threshold: float, topk: int, stride: torch.Tensor,
                scale: float) -> Dict[str, float]:
    """One image. ref_boxes (A, 4) and sims (A, C) float32 from the
    reference; boxes (n, 4), scores (n,), class_ids (n,) the n detections
    the system returned, best first; slots: the most it may return.
    Returns each detection's gaps (arrays) and the image's violations."""
    dev = ref_boxes.device
    boxes = boxes.to(dev, torch.float32)
    scores = scores.to(dev, torch.float32)
    class_ids = class_ids.to(dev, torch.int64)
    n, C = boxes.shape[0], sims.shape[1]
    best = sims.max(1).values
    none = np.zeros(0, np.float32)
    out = {'score_gap': none, 'class_gap': none, 'box_gap': none,
           'nms_violations': 0}
    kinds = dict.fromkeys(VIOLATIONS, 0)
    kinds['over_slots'] = max(0, n - slots)
    if n:
        ok = (class_ids >= 0) & (class_ids < C)
        cls = class_ids.clamp(0, C - 1)
        # (n, A) box errors and score errors of every pairing
        err = (boxes[:, None] - ref_boxes[None]).abs()
        side = torch.maximum(ref_boxes[:, 2] - ref_boxes[:, 0],
                             ref_boxes[:, 3] - ref_boxes[:, 1])
        bgap = err.amax(-1) / (stride / scale + side.clamp_min(0))[None]
        own_all = sims[:, cls].t()                                # (n, A)
        sgap = (scores[:, None] - own_all).abs()
        cgap = best[None, :] - own_all
        a = _assign(bgap + sgap + cgap)
        rb = ref_boxes[a]
        j = torch.arange(n, device=dev)
        own = torch.where(ok, sims[a, cls], torch.full_like(scores, -2.0))
        out['box_gap'] = bgap[j, a].cpu().numpy()
        out['score_gap'] = (scores - own).abs().cpu().numpy()
        out['class_gap'] = (best[a] - own).cpu().numpy()
        kinds['same_anchor'] = n - int(torch.unique(a).numel())
        kinds['below_conf'] = int((best[a] < conf - SCORE_MARGIN).sum())
        ov = iou(rb, rb)
        kinds['overlaps_higher'] = int(
            torch.triu(ov > iou_threshold + IOU_MARGIN, 1).sum())
    # anchors greedy NMS had to keep
    above = best > conf
    floor = conf
    if int(above.sum()) > topk:
        floor = max(floor, float(best.topk(topk).values[-1]))
    if n >= slots:
        floor = max(floor, float(scores[-1]))
    must = best > floor + SCORE_MARGIN
    if n:
        must[a] = False
    idx = must.nonzero().squeeze(1)
    if idx.numel():
        if n:
            higher = best[a][None, :] >= best[idx][:, None] - SCORE_MARGIN
            near = iou(ref_boxes[idx], rb) > iou_threshold - IOU_MARGIN
            covered = (higher & near).any(1)
            kinds['missed'] = int((~covered).sum())
        else:
            kinds['missed'] = int(idx.numel())
    out['nms_violations'] = sum(kinds.values())
    out['violations'] = kinds
    return out


def merge(readings: List[Dict]) -> Dict[str, float]:
    """Per-image readings -> the run's numbers: those compared (NUMBERS)
    and the largest score and class gaps beside them."""
    out: Dict[str, float] = {}
    for k in GAPS:
        v = np.concatenate([r[k] for r in readings] or [np.zeros(0)])
        out[k] = float(v.max()) if v.size else 0.0
    out['nms_violations'] = int(sum(r['nms_violations'] for r in readings))
    s = np.concatenate([r['score_gap'] for r in readings] or [np.zeros(0)])
    out['score_tail_share'] = float((s > TAIL_SCORE).mean()) if s.size else 0.0
    return out


def spread(readings: List[Dict]) -> Dict[str, list]:
    """Quantiles (50, 90, 99, 99.9, 100 %) of each gap over the detections,
    the detections judged and the violations by kind: what the limits were
    set from."""
    out = {}
    for k in GAPS:
        v = np.concatenate([r[k] for r in readings] or [np.zeros(1)])
        out[k] = [float(x) for x in np.quantile(v, [0.5, 0.9, 0.99, 0.999,
                                                    1.0])]
    out['detections'] = int(sum(r['score_gap'].size for r in readings))
    out['violations'] = {k: int(sum(r.get('violations', {}).get(k, 0)
                                    for r in readings))
                         for k in VIOLATIONS}
    return out


def verdict(numbers: Dict[str, float]) -> bool:
    return all(numbers[k] <= LIMITS[k] for k in NUMBERS)
