"""Anchor-target assignment for `assigner='topk_center'`. Counterpart of
`yoloclip_tpu/train/assign.py`.

For each ground-truth box, the top-k anchors by center distance whose
anchor point lies inside the box become positives; an anchor claimed by
several boxes goes to the nearest one (the first on a tie, as
`jnp.argmin`). Everything is fixed-shape and batched: masks, one top-k,
one min.

Outputs feed the clean combined loss (`train/losses.py`): per-anchor class
targets, box targets, DFL bin targets (the inverse of the exp-wh decode, so
decode(target) == gt) and a foreground mask.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

# distance of an anchor that may not take a ground-truth box
BIG = 1e9


def anchor_points(strides: Sequence[int], image_size: Tuple[int, int],
                  device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(A, 2) anchor points (grid * stride, the decode origin) and (A,)
    strides, level-major row-major -- the order of `decode_boxes`."""
    pts, sts = [], []
    H, W = image_size
    for s in strides:
        h, w = H // s, W // s
        gy, gx = torch.meshgrid(
            torch.arange(h, dtype=torch.float32, device=device),
            torch.arange(w, dtype=torch.float32, device=device),
            indexing='ij')
        pts.append(torch.stack([gx.reshape(-1), gy.reshape(-1)], -1) * s)
        sts.append(torch.full((h * w,), float(s), dtype=torch.float32,
                              device=device))
    return torch.cat(pts), torch.cat(sts)


def assign_batch(anchors: torch.Tensor, gt_boxes: torch.Tensor,
                 gt_cls: torch.Tensor, gt_valid: torch.Tensor,
                 topk: int = 10) -> Dict[str, torch.Tensor]:
    """anchors (A, 2); gt_boxes (B, M, 4) xyxy; gt_cls (B, M); gt_valid
    (B, M) bool -> fg_mask (B, A), cls_target (B, A) (-1 on background),
    box_target (B, A, 4) (0 on background), gt_index (B, A)."""
    B, M = gt_cls.shape
    A = anchors.shape[0]
    centers = torch.stack([(gt_boxes[..., 0] + gt_boxes[..., 2]) / 2,
                           (gt_boxes[..., 1] + gt_boxes[..., 3]) / 2], -1)
    # sqrt(dx^2 + dy^2), as jnp.linalg.norm computes it: the top-k
    # threshold below compares these values exactly
    diff = anchors[None, :, None, :] - centers[:, None, :, :]   # B,A,M,2
    d = torch.sqrt((diff * diff).sum(-1))                        # B,A,M
    ax, ay = anchors[None, :, 0:1], anchors[None, :, 1:2]        # 1,A,1
    g = gt_boxes[:, None]                                        # B,1,M,4
    inside = ((ax >= g[..., 0]) & (ax <= g[..., 2])
              & (ay >= g[..., 1]) & (ay <= g[..., 3]))
    eligible = inside & gt_valid[:, None, :]

    big = torch.tensor(BIG, dtype=d.dtype, device=d.device)
    d_masked = torch.where(eligible, d, big)
    # each box's k-th smallest distance: anchors within it are its top k
    k = min(topk, A)
    kth = torch.topk(d_masked, k, dim=1, largest=False).values[:, -1]  # B,M
    is_topk = (d_masked <= kth[:, None, :]) & eligible

    # multi-box anchors go to the nearest box, the first on a tie
    d_pos = torch.where(is_topk, d_masked, big)
    dmin = d_pos.min(dim=-1, keepdim=True).values
    idx = torch.arange(M, device=d.device).expand_as(d_pos)
    gt_index = torch.where(d_pos == dmin, idx,
                           torch.full_like(idx, M)).min(dim=-1).values
    fg = dmin[..., 0] < BIG / 2

    cls_at = torch.gather(gt_cls, 1, gt_index)
    box_at = torch.gather(gt_boxes, 1, gt_index[..., None].expand(-1, -1, 4))
    return {'fg_mask': fg,
            'cls_target': torch.where(fg, cls_at, torch.full_like(cls_at,
                                                                  -1)),
            'box_target': torch.where(fg[..., None], box_at,
                                      torch.zeros_like(box_at)),
            'gt_index': gt_index}


def dfl_targets_from_boxes(box_target: torch.Tensor, anchors: torch.Tensor,
                           anchor_strides: torch.Tensor,
                           reg_max: int = 16) -> torch.Tensor:
    """Invert the decode (xy = (grid + off) * stride, wh = exp(v) * stride)
    to per-coordinate continuous bin targets (..., A, 4), clipped to
    [0, reg_max]."""
    cx = (box_target[..., 0] + box_target[..., 2]) / 2
    cy = (box_target[..., 1] + box_target[..., 3]) / 2
    w = (box_target[..., 2] - box_target[..., 0]).clamp_min(1e-3)
    h = (box_target[..., 3] - box_target[..., 1]).clamp_min(1e-3)
    s = anchor_strides
    off_x = cx / s - anchors[..., 0] / s
    off_y = cy / s - anchors[..., 1] / s
    t = torch.stack([off_x, off_y, torch.log(w / s), torch.log(h / s)], -1)
    return t.clamp(0.0, float(reg_max))
