"""ctypes bindings for the port's native host loader, `dataload.cpp`.
Counterpart of `yoloclip_tpu/native/__init__.py`.

`dataload.cpp` does parallel JPEG/PNG decode + letterbox into a
preallocated NHWC uint8 slab (its header comment states the contract).
`_build.load_native` compiles it with g++ at first use into `_kernels/`.
Two availabilities, reported apart:

  * `available()`: the library loaded, so `letterbox_u8` works;
  * `codecs_available()`: it was built with libjpeg/libpng, so
    `decode_image`, `decode_bytes` and `load_batch` work too. Without the
    codec headers the library is built for the letterbox alone, and those
    three raise "native dataload unavailable".

Callers that can do without the library (`data/coco.py`, the detector on
the CPU) fall back to cv2/PIL when a function is unavailable; `require()`
raises with the build's error for callers that cannot.

Usage:
    from yoloclip_tpu_torch import native
    canvas, scale = native.letterbox_u8(img, (640, 640))
    if native.codecs_available():
        img = native.decode_image('x.jpg')                 # (H, W, 3) u8
        canvases, scales, nfail = native.load_batch(paths, (640, 640))
"""

from __future__ import annotations

import ctypes
import logging
import os
import threading
from typing import Optional, Sequence, Tuple

import numpy as np

from yoloclip_tpu_torch import _build

logger = logging.getLogger(__name__)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None     # why the library could not be loaded


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _error
    with _lock:
        if _lib is not None or _error is not None:
            return _lib
        try:
            lib = _build.load_native('dataload')
        except (RuntimeError, OSError) as e:
            _error = str(e)
            logger.info('native dataload unavailable: %s', e)
            return None
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.ycl_has_codecs.argtypes = []
        lib.ycl_has_codecs.restype = ctypes.c_int
        lib.ycl_image_info.argtypes = [u8p, ctypes.c_long,
                                       ctypes.POINTER(ctypes.c_int),
                                       ctypes.POINTER(ctypes.c_int)]
        lib.ycl_image_info.restype = ctypes.c_int
        lib.ycl_decode_rgb.argtypes = [u8p, ctypes.c_long, u8p]
        lib.ycl_decode_rgb.restype = ctypes.c_int
        lib.ycl_letterbox.argtypes = [u8p, ctypes.c_int, ctypes.c_int,
                                      u8p, ctypes.c_int, ctypes.c_int]
        lib.ycl_letterbox.restype = ctypes.c_float
        lib.ycl_load_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, u8p, ctypes.POINTER(ctypes.c_float),
            ctypes.c_int]
        lib.ycl_load_batch.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    """The library is built and loaded: `letterbox_u8` works."""
    return _load() is not None


def codecs_available() -> bool:
    """The library decodes JPEG/PNG: `decode_*` and `load_batch` work."""
    lib = _load()
    return lib is not None and lib.ycl_has_codecs() == 1


def require() -> ctypes.CDLL:
    """The loaded library, or RuntimeError with the reason it is not."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f'native dataload unavailable: {_error}')
    return lib


def _require_codecs() -> ctypes.CDLL:
    lib = require()
    if lib.ycl_has_codecs() != 1:
        raise RuntimeError('native dataload unavailable: built without '
                           'JPEG/PNG codecs (no libjpeg/libpng headers)')
    return lib


def _u8ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def decode_image(path: str) -> np.ndarray:
    """Decode a JPEG/PNG file to (H, W, 3) uint8 RGB."""
    _require_codecs()
    try:
        return decode_bytes(np.fromfile(path, np.uint8))
    except ValueError as e:
        raise ValueError(f'{e} ({path})') from None


def decode_bytes(buf) -> np.ndarray:
    """Decode an in-memory JPEG/PNG byte buffer to (H, W, 3) uint8 RGB --
    the HTTP serving path (`cli/serve.py`): request bodies never touch
    disk."""
    lib = _require_codecs()
    data = np.frombuffer(buf, np.uint8) if isinstance(buf, (bytes,
                                                            bytearray,
                                                            memoryview)) \
        else np.ascontiguousarray(buf, np.uint8)
    h, w = ctypes.c_int(), ctypes.c_int()
    if lib.ycl_image_info(_u8ptr(data), data.size,
                          ctypes.byref(h), ctypes.byref(w)) != 0:
        raise ValueError('cannot decode image buffer')
    out = np.empty((h.value, w.value, 3), np.uint8)
    if lib.ycl_decode_rgb(_u8ptr(data), data.size, _u8ptr(out)) != 0:
        raise ValueError('image buffer decode failed')
    return out


def letterbox_u8(img: np.ndarray,
                 target_hw: Tuple[int, int]) -> Tuple[np.ndarray, float]:
    """(H, W, 3) uint8 -> ((th, tw, 3) uint8 top-left letterbox, scale).
    The C call releases the GIL, so client threads letterbox in
    parallel."""
    lib = require()
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f'expected (H, W, 3) uint8, got {img.shape}')
    th, tw = target_hw
    canvas = np.zeros((th, tw, 3), np.uint8)
    scale = lib.ycl_letterbox(_u8ptr(img), img.shape[0], img.shape[1],
                              _u8ptr(canvas), th, tw)
    return canvas, float(scale)


def load_batch(paths: Sequence[str], target_hw: Tuple[int, int],
               nthreads: int = 0
               ) -> Tuple[np.ndarray, np.ndarray, int]:
    """Parallel decode+letterbox of image files.

    Returns (canvases (N, th, tw, 3) uint8, scales (N,) float32 -- 0.0
    marks a failed item, number of failures).
    """
    lib = _require_codecs()
    n = len(paths)
    th, tw = target_hw
    canvases = np.zeros((n, th, tw, 3), np.uint8)
    scales = np.zeros((n,), np.float32)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    if nthreads <= 0:
        nthreads = min(os.cpu_count() or 4, 16)
    nfail = lib.ycl_load_batch(
        arr, n, th, tw, _u8ptr(canvases),
        scales.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), nthreads)
    return canvases, scales, int(nfail)
