"""Box utilities. Counterpart of `yoloclip_tpu/ops/boxes.py`: format
conversions, areas, pairwise and matched-pair IoU, and the reference's
centered-letterbox helpers."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def xywh2xyxy(boxes: torch.Tensor) -> torch.Tensor:
    """(cx, cy, w, h) -> (x1, y1, x2, y2)."""
    cx, cy, w, h = boxes.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def xyxy2xywh(boxes: torch.Tensor) -> torch.Tensor:
    """(x1, y1, x2, y2) -> (cx, cy, w, h)."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    return torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1], -1)


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def pairwise_iou(a: torch.Tensor, b: torch.Tensor,
                 eps: float = 1e-7) -> torch.Tensor:
    """IoU of every box in a (..., N, 4) with every box in b (..., M, 4)
    -> (..., N, M): intersection sides clamped at 0, union + eps
    denominator, raw areas (the reference inference-NMS IoU)."""
    a = a[..., :, None, :]
    b = b[..., None, :, :]
    x1 = torch.maximum(a[..., 0], b[..., 0])
    y1 = torch.maximum(a[..., 1], b[..., 1])
    x2 = torch.minimum(a[..., 2], b[..., 2])
    y2 = torch.minimum(a[..., 3], b[..., 3])
    inter = (x2 - x1).clamp_min(0) * (y2 - y1).clamp_min(0)
    return inter / (box_area(a) + box_area(b) - inter + eps)


def elementwise_iou(a: torch.Tensor, b: torch.Tensor,
                    eps: float = 1e-7) -> torch.Tensor:
    """IoU of matched pairs: a, b both (..., 4) -> (...,)."""
    x1 = torch.maximum(a[..., 0], b[..., 0])
    y1 = torch.maximum(a[..., 1], b[..., 1])
    x2 = torch.minimum(a[..., 2], b[..., 2])
    y2 = torch.minimum(a[..., 3], b[..., 3])
    inter = (x2 - x1).clamp_min(0) * (y2 - y1).clamp_min(0)
    return inter / (box_area(a) + box_area(b) - inter + eps)


def compute_padding_size(original_hw: Sequence[int],
                         target_hw: Sequence[int]
                         ) -> Tuple[int, int, int, int]:
    """(top, bottom, left, right) padding of a CENTERED letterbox. The
    reference keeps these centered helpers in its utils, while its
    pipelines letterbox top-left (as `ops/preprocess.py` does); they are
    kept as the JAX package keeps them."""
    oh, ow = original_hw
    th, tw = target_hw
    ratio = min(th / oh, tw / ow)
    nh, nw = int(oh * ratio), int(ow * ratio)
    pt, pl = (th - nh) // 2, (tw - nw) // 2
    return (pt, th - nh - pt, pl, tw - nw - pl)


def adjust_box_coordinates(boxes: torch.Tensor, padding: Sequence[int],
                           scale_factor: float) -> torch.Tensor:
    """Original-image xyxy boxes -> a (possibly centered) letterboxed
    frame: scale, then add the padding offsets."""
    pad_top, _, pad_left, _ = padding
    x = boxes * scale_factor
    return x + torch.tensor([pad_left, pad_top, pad_left, pad_top],
                            dtype=x.dtype, device=x.device)
