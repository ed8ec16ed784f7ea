"""Greedy NMS keep mask: CUDA kernel + plain version.

Replaces `yoloclip_tpu/ops/pallas/nms.py::nms_keep_pallas`. Candidates
arrive sorted by score, best first; keep[i] holds iff candidate i is valid
and no kept candidate ranked before it overlaps it with
`pairwise_iou > iou_threshold` -- the exact greedy result of
`yoloclip_tpu/ops/nms.py::_greedy_keep`.

`nms_keep` calls the custom op `yoloclip::nms_keep`
(`ops/kernels/library.py`), which runs `nms_keep_plain` (the fixed-point
iteration of `_fixpoint_keep` over `pairwise_iou`) for CPU tensors and the
CUDA kernel (`csrc/nms.cu`) for CUDA tensors; it never swaps one for the
other. Both
use the IoU of `ops/boxes.py::pairwise_iou` with every operation rounded
on its own, so their keep masks are bit-identical.

The kernel takes any number K of candidates: one launch builds the overlap
bitmask of the upper triangle, in 64 x 64 candidate tiles spread over the
whole card, into a (B, W, 32 W) uint32 scratch tensor, W = ceil(K / 32),
that the wrapper allocates (128 KB an image at K = 1024, 8.8 MB at
K = 8400), skipping tiles with no valid candidate; a second launch makes
the greedy pass, one block an image, 32 candidates at a time.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from yoloclip_tpu_torch import _build
from yoloclip_tpu_torch.ops.kernels import library
from yoloclip_tpu_torch.ops.boxes import pairwise_iou

# Launches of the CUDA kernel (incremented only where it launches).
launches = 0
_count_lock = threading.Lock()   # shards on threads launch too

# `stages` of the C launcher: the mask build, the greedy scan, or both.
BUILD, SCAN, BOTH = 1, 2, 3
MAX_IMAGES = 65535     # images go on the build grid's y dimension

_lib_fn = None


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


def _fn():
    """The loaded library and its C launcher, argtypes set once."""
    global _lib_fn
    if _lib_fn is None:
        lib = _build.load('nms')
        fn = lib.yc_nms_keep
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib_fn = (lib, fn)
    return _lib_fn


def _operand(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """t in `dtype`, contiguous, on a 16-byte boundary (the kernel reads a
    box as one float4); copied only when it is not all three already."""
    t = t.to(dtype).contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check(boxes: torch.Tensor, valid: torch.Tensor) -> None:
    if boxes.dim() != 3 or boxes.shape[-1] != 4:
        raise ValueError(f'NMS kernel takes boxes (B, K, 4), got '
                         f'{tuple(boxes.shape)}')
    if tuple(valid.shape) != tuple(boxes.shape[:2]):
        raise ValueError(f'valid {tuple(valid.shape)} does not match boxes '
                         f'{tuple(boxes.shape)}')
    if boxes.shape[0] > MAX_IMAGES:
        raise ValueError(f'NMS kernel takes at most {MAX_IMAGES} images a '
                         f'call (got {boxes.shape[0]})')


def scratch(B: int, K: int, device) -> torch.Tensor:
    """The overlap bitmask the kernel fills: (B, W, 32 W) int32 words,
    W = ceil(K / 32); left uninitialised (the kernel reads only what it
    wrote, see csrc/nms.cu)."""
    W = (K + 31) // 32
    return torch.empty((B, W, 32 * W), dtype=torch.int32, device=device)


def _run(boxes: torch.Tensor, valid: torch.Tensor, mask: torch.Tensor,
         keep: torch.Tensor, iou_threshold: float, stages: int) -> None:
    """Launch `stages` on prepared operands: boxes (B, K, 4) and valid
    (B, K) from `_operand`, mask from `scratch`, keep (B, K) bool."""
    lib, fn = _fn()
    B, K = valid.shape
    err = fn(boxes.data_ptr(), valid.data_ptr(), mask.data_ptr(),
             keep.data_ptr(), B, K, iou_threshold, stages,
             torch.cuda.current_stream(boxes.device).cuda_stream)
    _build.check(lib, err, 'NMS kernel launch')


def _launch(boxes: torch.Tensor, valid: torch.Tensor,
            iou_threshold: float) -> torch.Tensor:
    global launches
    _check(boxes, valid)
    B, K, _ = boxes.shape
    keep = torch.empty((B, K), dtype=torch.bool, device=boxes.device)
    if B == 0 or K == 0:
        return keep
    _run(_operand(boxes, torch.float32), _operand(valid, torch.bool),
         scratch(B, K, boxes.device), keep, iou_threshold, BOTH)
    with _count_lock:
        launches += 1
    return keep


def _keep_cpu(boxes: torch.Tensor, valid: torch.Tensor,
              iou_threshold: float) -> torch.Tensor:
    keep = nms_keep_plain(boxes.float(), valid.to(torch.bool), iou_threshold)
    # with nothing suppressed the plain fixed point is `valid` itself; an
    # op's output must not alias its input
    return keep.clone() if keep is valid else keep


def _keep_fake(boxes: torch.Tensor, valid: torch.Tensor,
               iou_threshold: float) -> torch.Tensor:
    return boxes.new_empty(boxes.shape[:2], dtype=torch.bool)


KEEP_OP = library.KernelOp(
    'nms_keep', 'NMS',
    '(Tensor boxes, Tensor valid, float iou_threshold) -> Tensor',
    _keep_cpu, _launch, _keep_fake)


def nms_keep(boxes: torch.Tensor, valid: torch.Tensor,
             iou_threshold: float) -> torch.Tensor:
    """boxes (B, K, 4) xyxy sorted by score (best first), valid (B, K)
    bool -> keep (B, K) bool."""
    thr = float(np.float32(iou_threshold))   # compared in float32, as in JAX
    return KEEP_OP(boxes, valid, thr)
