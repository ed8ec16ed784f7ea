"""Image helpers of `yoloclip_tpu/data/coco.py` (the port's own copies):
file decode and host resize. The COCO dataset itself comes with the
training slice.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _imread_rgb(path: str) -> np.ndarray:
    # native C++ decoder first (yoloclip_tpu_torch/native): byte-identical
    # to the JAX package's and thread-pool friendly; cv2 / PIL after it,
    # also where the library was built without codecs
    from yoloclip_tpu_torch import native
    if native.codecs_available():
        try:
            return native.decode_image(path)
        except ValueError:
            pass  # unusual format (bmp/tiff/...): fall through to cv2/PIL
    try:
        import cv2
        img = cv2.imread(path)
        if img is None:
            raise FileNotFoundError(path)
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    except ImportError:
        from PIL import Image
        return np.asarray(Image.open(path).convert('RGB'))


def _resize(img: np.ndarray, wh: Tuple[int, int]) -> np.ndarray:
    w, h = wh
    try:
        import cv2
        return cv2.resize(img, (w, h))
    except ImportError:
        pass
    try:
        from PIL import Image
        return np.asarray(Image.fromarray(img).resize((w, h)))
    except ImportError:
        return _resize_numpy_bilinear(img, w, h)


def _resize_numpy_bilinear(img: np.ndarray, w: int, h: int) -> np.ndarray:
    """Pure-numpy bilinear resize (half-pixel centers, cv2/PIL convention),
    the last resort on hosts with neither cv2 nor PIL. Within ~1 LSB of
    cv2's INTER_LINEAR away from borders."""
    ih, iw = img.shape[:2]
    x = (np.arange(w, dtype=np.float64) + 0.5) * (iw / w) - 0.5
    y = (np.arange(h, dtype=np.float64) + 0.5) * (ih / h) - 0.5
    x0 = np.clip(np.floor(x).astype(np.int64), 0, iw - 1)
    y0 = np.clip(np.floor(y).astype(np.int64), 0, ih - 1)
    x1 = np.minimum(x0 + 1, iw - 1)
    y1 = np.minimum(y0 + 1, ih - 1)
    fx = np.clip(x - x0, 0.0, 1.0)[None, :, None]
    fy = np.clip(y - y0, 0.0, 1.0)[:, None, None]
    im = img.astype(np.float64)
    top = im[y0[:, None], x0[None, :]] * (1 - fx) + im[y0[:, None],
                                                       x1[None, :]] * fx
    bot = im[y1[:, None], x0[None, :]] * (1 - fx) + im[y1[:, None],
                                                       x1[None, :]] * fx
    out = top * (1 - fy) + bot * fy
    if np.issubdtype(img.dtype, np.integer):
        return np.clip(np.rint(out), 0, 255).astype(img.dtype)
    return out.astype(img.dtype)
