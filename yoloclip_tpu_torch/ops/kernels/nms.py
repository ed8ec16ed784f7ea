"""Greedy NMS keep mask: CUDA kernel + plain version.

Replaces `yoloclip_tpu/ops/pallas/nms.py::nms_keep_pallas`. Candidates
arrive sorted by score, best first; keep[i] holds iff candidate i is valid
and no kept candidate ranked before it overlaps it with
`pairwise_iou > iou_threshold` -- the exact greedy result of
`yoloclip_tpu/ops/nms.py::_greedy_keep`.

`nms_keep` runs `nms_keep_plain` (the fixed-point iteration of
`_fixpoint_keep` over `pairwise_iou`) for CPU tensors and the CUDA kernel
(`csrc/nms.cu`) for CUDA tensors; it never swaps one for the other. Both
use the IoU of `ops/boxes.py::pairwise_iou` with every operation rounded
on its own, so their keep masks are bit-identical.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from yoloclip_tpu_torch import _build
from yoloclip_tpu_torch.ops.boxes import pairwise_iou

MAX_K = 1024   # csrc/nms.cu keeps a K x K bitmask in shared memory

# Launches of the CUDA kernel (incremented only where it launches).
launches = 0


def nms_keep_plain(boxes: torch.Tensor, valid: torch.Tensor,
                   iou_threshold: float) -> torch.Tensor:
    """boxes (B, K, 4) float32 score-sorted, valid (B, K) bool -> keep
    (B, K) bool, by iterating
        keep[j] <- valid[j] & ~any_{i<j}(over[i, j] & keep[i])
    to its fixed point (the greedy answer; one sweep per chain link)."""
    K = boxes.shape[1]
    iou = pairwise_iou(boxes, boxes)
    idx = torch.arange(K, device=boxes.device)
    over = (iou > iou_threshold) & (idx[:, None] < idx[None, :])
    keep = valid
    while True:
        suppressed = (over & keep[:, :, None]).any(dim=1)
        new_keep = valid & ~suppressed
        if torch.equal(new_keep, keep):
            return keep
        keep = new_keep


def _launch(boxes: torch.Tensor, valid: torch.Tensor,
            iou_threshold: float) -> torch.Tensor:
    global launches
    B, K, _ = boxes.shape
    if K > MAX_K:
        raise ValueError(f'NMS kernel takes at most {MAX_K} candidates per '
                         f'image (got {K}); lower nms_topk')
    keep = torch.empty((B, K), dtype=torch.bool, device=boxes.device)
    if B == 0 or K == 0:
        return keep
    lib = _build.load('nms')
    fn = lib.yc_nms_keep
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    b = boxes.float().contiguous()
    if b.data_ptr() % 16:      # the kernel reads each box as one float4
        b = b.clone()
    v = valid.to(torch.bool).contiguous()
    err = fn(b.data_ptr(), v.data_ptr(), keep.data_ptr(), B, K,
             iou_threshold,
             torch.cuda.current_stream(boxes.device).cuda_stream)
    _build.check(lib, err, 'NMS kernel launch')
    launches += 1
    return keep


def nms_keep(boxes: torch.Tensor, valid: torch.Tensor,
             iou_threshold: float) -> torch.Tensor:
    """boxes (B, K, 4) xyxy sorted by score (best first), valid (B, K)
    bool -> keep (B, K) bool."""
    thr = float(np.float32(iou_threshold))   # compared in float32, as in JAX
    if boxes.device.type == 'cpu':
        return nms_keep_plain(boxes.float(), valid.to(torch.bool), thr)
    if boxes.device.type == 'cuda':
        return _launch(boxes, valid, thr)
    raise RuntimeError(f'no NMS kernel for device {boxes.device}')
