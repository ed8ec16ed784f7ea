"""Published peaks of one NVIDIA H100 SXM and the operations and bytes of
the work the benchmark measures.

A kernel's bound is the least time the chip could take for it: the larger
of its operations over the peak of the units it runs on and its bytes
(each input read once, each output written once) over HBM's rate. Its
roofline share is that bound over the device time it took.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

# NVIDIA's data sheet, SXM part, dense (no sparsity), at the 700 W limit.
BF16_TENSOR = 989e12       # FLOP/s
TF32_TENSOR = 495e12
FP32_CORES = 67e12
HBM_BYTES_PER_S = 3.35e12


def bound_s(ops: float, nbytes: float, peak: float) -> Tuple[float, str]:
    """(least seconds, 'operations' or 'bytes')."""
    t_ops, t_bytes = ops / peak, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes), ('operations' if t_ops >= t_bytes
                                 else 'bytes')


def similarity_cost(B: int, A: int, hidden: int, C: int, E: int,
                    esize: int = 2) -> Tuple[float, float]:
    """(operations, bytes) of the folded region-text similarity over B
    images and A anchors: the fewer operations of the two formulations
    (folded onto the text, 2 B A hidden (C + E); or projection then cosine,
    2 B A (hidden E + E C)); bytes: h (B, A, hidden) and the folded text
    (B, C, hidden) and K (hidden, E) in the compute type, the text bias
    (B, C) and the projection bias (E,) in float32, scores and ids out."""
    ops = min(2 * B * A * hidden * (C + E), 2 * B * A * (hidden * E + E * C))
    nbytes = (B * A * hidden * esize + B * C * hidden * esize + B * C * 4
              + hidden * E * esize + E * 4 + B * A * 8)
    return float(ops), float(nbytes)


def nms_cost(valid: Sequence[int], K: int) -> Tuple[float, float]:
    """(operations, bytes) of the greedy NMS keep mask over images with
    `valid` candidates each in a pool of K (a count above K is held to K:
    the pool holds no more): 12 float32 operations for each IoU of a pair
    of valid candidates; boxes, the valid flags and the keep mask once."""
    held = [min(n, K) for n in valid]
    pairs = sum(n * (n - 1) // 2 for n in held)
    return float(12 * pairs), float(len(valid) * K * (16 + 1 + 1))


def model_flops_per_image(variant: str, classes: int,
                          hw: Tuple[int, int] = (640, 640)) -> float:
    """FLOPs of one image through the plain reference's forward, counted by
    `FlopCounterMode` on the meta device (no memory, no time): the same
    count whatever implements the step."""
    from torch.utils.flop_counter import FlopCounterMode

    from perfbench.reference.model import YOLOCLIPReference
    with torch.device('meta'):
        m = YOLOCLIPReference(variant)
        x = torch.empty((1, 3) + tuple(hw))
        t = torch.empty((classes, 512))
    with FlopCounterMode(display=False) as fc:
        m(x, t)
    return float(fc.get_total_flops())
