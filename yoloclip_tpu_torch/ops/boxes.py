"""Box utilities. Counterpart of `yoloclip_tpu/ops/boxes.py`."""

from __future__ import annotations

import torch


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
