"""The plain letterbox of the batch path: scale = min(th / h, tw / w); a
bilinear resize to (int(h scale), int(w scale)) with cv2's half-pixel rule
(INTER_LINEAR, no antialias, edges clamped) written as two float32 matmuls
against interpolation matrices; paste at the top left of a black canvas;
divide by 255.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def bilinear_matrix(src: int, dst: int) -> np.ndarray:
    """(dst, src) float32 weights: out[i] = (1 - f) in[lo] + f in[lo + 1],
    pos = (i + 0.5) src / dst - 0.5, indices clamped."""
    pos = (np.arange(dst, dtype=np.float64) + 0.5) * (src / dst) - 0.5
    lo = np.floor(pos).astype(np.int64)
    frac = pos - lo
    m = np.zeros((dst, src), np.float32)
    rows = np.arange(dst)
    np.add.at(m, (rows, np.clip(lo, 0, src - 1)),
              (1.0 - frac).astype(np.float32))
    np.add.at(m, (rows, np.clip(lo + 1, 0, src - 1)),
              frac.astype(np.float32))
    return m


def resized_size(h: int, w: int, th: int, tw: int) -> Tuple[float, int, int]:
    scale = min(th / h, tw / w)
    return scale, int(h * scale), int(w * scale)


def device_letterbox(frames: torch.Tensor, target: Tuple[int, int]
                     ) -> Tuple[torch.Tensor, float]:
    """(B, H, W, 3) uint8 -> (float32 canvases (B, th, tw, 3) in [0, 1],
    scale)."""
    B, h, w, C = frames.shape
    th, tw = target
    scale, rh, rw = resized_size(h, w, th, tw)
    x = frames.float()
    if (rh, rw) != (h, w):
        mh = torch.from_numpy(bilinear_matrix(h, rh)).to(x.device)
        mw = torch.from_numpy(bilinear_matrix(w, rw)).to(x.device)
        x = torch.einsum('ih,bhwc->biwc', mh, x)
        x = torch.einsum('jw,biwc->bijc', mw, x)
    canvas = torch.zeros((B, th, tw, C), dtype=torch.float32,
                         device=frames.device)
    canvas[:, :rh, :rw] = x
    return canvas / 255.0, scale
