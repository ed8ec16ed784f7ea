"""Fixed-shape batched greedy NMS. Counterpart of `yoloclip_tpu/ops/nms.py`.

Confidence mask -> prefilter-saturation flag -> top-min(topk, A)
prefilter -> greedy keep mask (`ops/kernels/nms.py`) -> top max_detections
of the kept candidates, with fixed output shapes and a validity mask.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from yoloclip_tpu_torch.ops.kernels.nms import nms_keep

NEG_INF = -1e30


def _top(x: torch.Tensor, k: int):
    """Top-k along the last dim with `lax.top_k`'s tie order (the lower
    index first); torch.topk does not promise it, a stable sort does."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def batched_nms(boxes: torch.Tensor, scores: torch.Tensor,
                class_ids: Optional[torch.Tensor],
                conf_threshold: float = 0.25, iou_threshold: float = 0.45,
                topk: int = 1024, max_detections: int = 300,
                class_agnostic: bool = True) -> Dict[str, torch.Tensor]:
    """boxes (B, A, 4), scores (B, A), class_ids (B, A) or None ->
    dict of boxes (B, D, 4), scores (B, D), valid (B, D), count (B,),
    prefilter_saturated (B,) and class_ids (B, D) when given, with
    D = min(max_detections, min(topk, A)), sorted by score.

    class_agnostic=False suppresses per class by offsetting each class into
    its own coordinate region; the outputs keep the real coordinates."""
    B, A = scores.shape
    K = min(topk, A)
    conf = float(np.float32(conf_threshold))
    above = scores > conf
    scores_f = torch.where(above, scores.float(),
                           torch.full_like(scores, NEG_INF, dtype=torch.float32))
    # more candidates above the threshold than the prefilter holds: the
    # result may differ from unbounded greedy NMS
    saturated = above.sum(dim=-1) > K
    top_scores, top_idx = _top(scores_f, K)
    top_boxes = torch.gather(boxes.float(), 1,
                             top_idx[..., None].expand(-1, -1, 4))
    valid = top_scores > NEG_INF / 2

    keep_boxes = top_boxes
    if not class_agnostic:
        if class_ids is None:
            raise ValueError('class-aware NMS requires class_ids')
        cls = torch.gather(class_ids, 1, top_idx)
        span = top_boxes.abs().max() + 1.0
        keep_boxes = top_boxes + (cls.float() * span)[..., None]

    keep = nms_keep(keep_boxes, valid, iou_threshold)

    D = min(max_detections, K)
    kept_scores = torch.where(keep, top_scores,
                              torch.full_like(top_scores, NEG_INF))
    out_scores, sel = _top(kept_scores, D)
    out_valid = out_scores > NEG_INF / 2
    out_boxes = torch.where(
        out_valid[..., None],
        torch.gather(top_boxes, 1, sel[..., None].expand(-1, -1, 4)),
        torch.zeros((), dtype=torch.float32, device=boxes.device))
    out = {
        'boxes': out_boxes,
        'scores': torch.where(out_valid, out_scores,
                              torch.zeros_like(out_scores)),
        'valid': out_valid,
        'count': out_valid.sum(dim=-1, dtype=torch.int32),
        'prefilter_saturated': saturated,
    }
    if class_ids is not None:
        top_cls = torch.gather(class_ids, 1, top_idx)
        out['class_ids'] = torch.where(
            out_valid, torch.gather(top_cls, 1, sel),
            torch.full_like(sel, -1, dtype=class_ids.dtype))
    return out


def nms_fixed(boxes: torch.Tensor, scores: torch.Tensor,
              conf_threshold: float = 0.25, iou_threshold: float = 0.45,
              topk: int = 1024, max_detections: int = 300,
              class_ids: Optional[torch.Tensor] = None,
              class_agnostic: bool = True) -> Dict[str, torch.Tensor]:
    """Single-image NMS: boxes (A, 4), scores (A,), class_ids (A,) or None
    -> the `batched_nms` dict without its batch dimension."""
    out = batched_nms(boxes[None], scores[None],
                      None if class_ids is None else class_ids[None],
                      conf_threshold, iou_threshold, topk, max_detections,
                      class_agnostic)
    return {k: v[0] for k, v in out.items()}
