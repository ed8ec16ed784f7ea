"""Device letterbox. Counterpart of `yoloclip_tpu/ops/preprocess.py`.

scale = min(th / h, tw / w); bilinear resize to (int(h*scale), int(w*scale))
with cv2 INTER_LINEAR half-pixel rules (no antialias), written as two
matmuls against constant interpolation matrices; paste at the TOP-LEFT of
a black (th, tw) canvas; divide by 255. Frames stay in the JAX layout,
(B, H, W, 3), so `.permute(0, 3, 1, 2)` hands the model a channels_last
NCHW view without a copy. `letterbox_batch_u8_s2d` is the layout of the
uint8 space-to-depth stem (`ModelConfig.stem_u8_s2d`): the resized frame
rounded to uint8, no /255, space-to-depth'd to (B, th/2, tw/2, 12).
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import numpy as np
import torch

from yoloclip_tpu_torch.models.layers import space_to_depth2


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


# (src, dst, device) -> the matrix on the device, uploaded once and never
# evicted: a captured program (`inference/program.py`) reads it at a fixed
# address, and an upload inside a capture would raise.
_ON_DEVICE: Dict[tuple, torch.Tensor] = {}


def _bilinear_on(src: int, dst: int, device: torch.device) -> torch.Tensor:
    key = (src, dst, device)
    m = _ON_DEVICE.get(key)
    if m is None:    # setdefault: racing threads all get the first upload
        m = _ON_DEVICE.setdefault(
            key, torch.from_numpy(_bilinear_matrix(src, dst)).to(device))
    return m


def _resize(x: torch.Tensor, rh: int, rw: int) -> torch.Tensor:
    """(B, h, w, C) float32 -> (B, rh, rw, C) bilinear, as two matmuls."""
    B, h, w, C = x.shape
    if (rh, rw) == (h, w):
        return x   # the half-pixel matrix at src == dst is the identity
    Rh = _bilinear_on(h, rh, x.device)
    Rw = _bilinear_on(w, rw, x.device)
    t = torch.matmul(Rh, x.reshape(B, h, w * C))           # (B, rh, w*C)
    t = t.reshape(B, rh, w, C).transpose(2, 3)             # (B, rh, C, w)
    return torch.matmul(t, Rw.t()).transpose(2, 3)         # (B, rh, rw, C)


def letterbox_batch(images: torch.Tensor,
                    target_hw: Tuple[int, int] = (640, 640)
                    ) -> Tuple[torch.Tensor, float]:
    """(B, H, W, 3) same-size uint8/float frames -> (float32 canvases
    (B, th, tw, 3) in [0, 1], scale)."""
    B, h, w, C = images.shape
    th, tw = target_hw
    scale = min(th / h, tw / w)
    rh, rw = int(h * scale), int(w * scale)
    resized = _resize(images.float(), rh, rw)
    if (rh, rw) == (th, tw):
        return resized / 255.0, scale
    canvas = torch.zeros((B, th, tw, C), dtype=torch.float32,
                         device=images.device)
    canvas[:, :rh, :rw] = resized
    return canvas / 255.0, scale


def letterbox_batch_u8_s2d(images: torch.Tensor,
                           target_hw: Tuple[int, int] = (640, 640)
                           ) -> Tuple[torch.Tensor, float]:
    """(B, H, W, 3) -> (uint8 (B, th/2, tw/2, 12) space-to-depth canvas,
    scale). The canvas stays 0..255 (the stem folds the /255 into its
    kernel); a real resize rounds the fp32 bilinear result to uint8 (ties
    to even) and clips it, as does a float frame at scale 1; a uint8 frame
    at scale 1 is only relaid out."""
    B, h, w, C = images.shape
    th, tw = target_hw
    scale = min(th / h, tw / w)
    rh, rw = int(h * scale), int(w * scale)
    if (rh, rw) == (h, w) and images.dtype == torch.uint8:
        resized = images
    else:
        resized = torch.clamp(torch.round(_resize(images.float(), rh, rw)),
                              0, 255).to(torch.uint8)
    if (rh, rw) == (th, tw):
        return space_to_depth2(resized), scale
    canvas = torch.zeros((B, th, tw, C), dtype=torch.uint8,
                         device=images.device)
    canvas[:, :rh, :rw] = resized
    return space_to_depth2(canvas), scale


def letterbox(image: torch.Tensor, target_hw: Tuple[int, int] = (640, 640)
              ) -> Tuple[torch.Tensor, float]:
    """One (H, W, 3) frame -> (float32 (th, tw, 3) canvas, scale)."""
    canvas, scale = letterbox_batch(image[None], target_hw)
    return canvas[0], scale


def letterbox_u8_s2d(image: torch.Tensor,
                     target_hw: Tuple[int, int] = (640, 640)
                     ) -> Tuple[torch.Tensor, float]:
    """One (H, W, 3) frame -> (uint8 (th/2, tw/2, 12) canvas, scale)."""
    canvas, scale = letterbox_batch_u8_s2d(image[None], target_hw)
    return canvas[0], scale


def letterbox_batch_for(model_cfg):
    """The batch letterbox whose canvases the model of `model_cfg` takes:
    the uint8 space-to-depth one under stem_u8_s2d, else the float one."""
    return (letterbox_batch_u8_s2d if model_cfg.stem_u8_s2d
            else letterbox_batch)


def rescale_boxes(boxes: torch.Tensor, scale: float,
                  orig_hw: Tuple[int, int]) -> torch.Tensor:
    """Letterboxed-pixel xyxy -> original-image xyxy, clipped to the frame.
    The scale is applied in float32, as the JAX package does."""
    oh, ow = orig_hw
    boxes = boxes / float(np.float32(scale))
    hi = boxes.new_empty(4)      # filled on the device: no upload
    hi[0::2], hi[1::2] = ow, oh
    return torch.minimum(boxes.clamp_min(0), hi)
