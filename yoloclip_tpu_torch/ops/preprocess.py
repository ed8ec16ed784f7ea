"""Device letterbox. Counterpart of `yoloclip_tpu/ops/preprocess.py`.

scale = min(th / h, tw / w); bilinear resize to (int(h*scale), int(w*scale))
with cv2 INTER_LINEAR half-pixel rules (no antialias), written as two
matmuls against constant interpolation matrices; paste at the TOP-LEFT of
a black (th, tw) canvas; divide by 255. Frames stay in the JAX layout,
(B, H, W, 3), so `.permute(0, 3, 1, 2)` hands the model a channels_last
NCHW view without a copy.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch


@functools.lru_cache(maxsize=256)
def _bilinear_matrix(src: int, dst: int) -> np.ndarray:
    """(dst, src) half-pixel bilinear interpolation weights, cv2-style
    (INTER_LINEAR, no antialias): out[i] = (1-f)*in[lo] + f*in[lo+1] with
    pos = (i + 0.5) * src/dst - 0.5, edges clamped. A copy of
    `yoloclip_tpu/ops/preprocess.py::_bilinear_matrix`, whose module
    imports jax."""
    pos = (np.arange(dst, dtype=np.float64) + 0.5) * (src / dst) - 0.5
    lo = np.floor(pos).astype(np.int64)
    frac = (pos - lo).astype(np.float64)
    lo_c = np.clip(lo, 0, src - 1)
    hi_c = np.clip(lo + 1, 0, src - 1)
    W = np.zeros((dst, src), np.float32)
    rows = np.arange(dst)
    np.add.at(W, (rows, lo_c), (1.0 - frac).astype(np.float32))
    np.add.at(W, (rows, hi_c), frac.astype(np.float32))
    return W


def letterbox_batch(images: torch.Tensor,
                    target_hw: Tuple[int, int] = (640, 640)
                    ) -> Tuple[torch.Tensor, float]:
    """(B, H, W, 3) same-size uint8/float frames -> (float32 canvases
    (B, th, tw, 3) in [0, 1], scale)."""
    B, h, w, C = images.shape
    th, tw = target_hw
    scale = min(th / h, tw / w)
    rh, rw = int(h * scale), int(w * scale)
    x = images.float()
    if (rh, rw) == (h, w):
        resized = x   # the half-pixel matrix at src == dst is the identity
    else:
        Rh = torch.from_numpy(_bilinear_matrix(h, rh)).to(x.device)
        Rw = torch.from_numpy(_bilinear_matrix(w, rw)).to(x.device)
        t = torch.matmul(Rh, x.reshape(B, h, w * C))           # (B, rh, w*C)
        t = t.reshape(B, rh, w, C).transpose(2, 3)             # (B, rh, C, w)
        resized = torch.matmul(t, Rw.t()).transpose(2, 3)      # (B, rh, rw, C)
    if (rh, rw) == (th, tw):
        return resized / 255.0, scale
    canvas = torch.zeros((B, th, tw, C), dtype=torch.float32,
                         device=x.device)
    canvas[:, :rh, :rw] = resized
    return canvas / 255.0, scale


def letterbox(image: torch.Tensor, target_hw: Tuple[int, int] = (640, 640)
              ) -> Tuple[torch.Tensor, float]:
    """One (H, W, 3) frame -> (float32 (th, tw, 3) canvas, scale)."""
    canvas, scale = letterbox_batch(image[None], target_hw)
    return canvas[0], scale


def rescale_boxes(boxes: torch.Tensor, scale: float,
                  orig_hw: Tuple[int, int]) -> torch.Tensor:
    """Letterboxed-pixel xyxy -> original-image xyxy, clipped to the frame.
    The scale is applied in float32, as the JAX package does."""
    oh, ow = orig_hw
    boxes = boxes / float(np.float32(scale))
    hi = torch.tensor([ow, oh, ow, oh], dtype=boxes.dtype,
                      device=boxes.device)
    return torch.minimum(boxes.clamp_min(0), hi)
