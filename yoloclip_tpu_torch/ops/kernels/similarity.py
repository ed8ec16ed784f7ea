"""Region-text cosine max/argmax: two modes of one CUDA kernel
(`csrc/similarity.cu`), each with its plain PyTorch version.

Folded: `fused_projected_similarity_argmax` replaces
`yoloclip_tpu/ops/pallas/similarity.py::fused_projected_similarity_argmax`.
For raw hidden activations h, the head's 1x1 projection (K, b) and
L2-normalised per-image text t it returns

    scores[b, a] = max_c  cos(h[b, a] K + b, t[b, c])      (c < num_valid)
    ids[b, a]    = the lowest c attaining that max

without materialising the (B, A, E) projected embeddings or the (B, A, C)
similarity. The projection folds onto the text side, exactly as the JAX
function does: tp = t K^T in the compute dtype (fp32 accumulation), and
cb = t . b in fp32; only the final max is divided by ||h K + b||.
Plain version: `similarity_argmax_plain`.

Unprojected: `fused_similarity_argmax` replaces
`yoloclip_tpu/ops/pallas/similarity.py::fused_similarity_argmax`. For
already-projected rows obj and L2-normalised text t it returns the max and
lowest argmax of obj . t over c < num_valid, the max divided by
max(||obj||, 1e-12) when normalize_obj is set, without materialising
(B, A, C). Plain version: `similarity_argmax_reference_plain`.

Each wrapper runs its plain version for CPU tensors and the CUDA kernel for
CUDA tensors; it never swaps one for the other.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from yoloclip_tpu_torch import _build

NEG = -1e30

# Launches of the CUDA kernel, folded and unprojected mode (incremented
# only where each launches).
launches = 0
unprojected_launches = 0


def _fold_text(text: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
               dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """tp = text K^T in `dtype` (products of `dtype` values, fp32 sums,
    one rounding to `dtype`); cb = text . b in fp32. As
    `similarity.py:281-284` of the JAX package."""
    tp = torch.matmul(text.to(dtype).float(),
                      kernel.to(dtype).float().t()).to(dtype)
    cb = torch.matmul(text.float(), bias.float())
    return tp, cb


def _masked_max(raw: torch.Tensor, num_valid: Optional[int]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Max and lowest argmax over the last axis, columns >= num_valid set
    to NEG first."""
    if num_valid is not None:
        col = torch.arange(raw.shape[-1], device=raw.device)
        raw = torch.where(col < num_valid, raw, torch.full_like(raw, NEG))
    return raw.max(dim=-1)   # ties: the lowest index


def similarity_argmax_plain(h: torch.Tensor, text: torch.Tensor,
                            kernel: torch.Tensor, bias: torch.Tensor,
                            num_valid: Optional[int] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The folded algebra in PyTorch ops. h (B, A, Kd) in the compute
    dtype; text (B, C, E) L2-normalised; kernel (Kd, E); bias (E,).
    Returns scores (B, A) float32 and ids (B, A) int32."""
    dt = h.dtype
    tp, cb = _fold_text(text, kernel, bias, dt)
    hf = h.float()
    raw = torch.matmul(hf, tp.float().transpose(1, 2)) + cb[:, None, :]
    best, ids = _masked_max(raw, num_valid)
    obj = torch.matmul(hf, kernel.to(dt).float()) + bias.float()
    norm = torch.linalg.vector_norm(obj, dim=-1)
    return best / norm.clamp_min(1e-12), ids.to(torch.int32)


def _launch(h: torch.Tensor, tp: torch.Tensor, cb: torch.Tensor,
            kernel: torch.Tensor, bias: torch.Tensor, nvalid: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    global launches
    B, A, Kd = h.shape
    C, E = tp.shape[1], kernel.shape[1]
    if h.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f'similarity kernel takes float32 or bfloat16, '
                        f'got {h.dtype}')
    if Kd % 32 or Kd > 512 or E % 64:
        raise ValueError(f'similarity kernel needs hidden % 32 == 0, '
                         f'hidden <= 512 and E % 64 == 0 (got {Kd}, {E})')
    scores = torch.empty((B, A), dtype=torch.float32, device=h.device)
    ids = torch.empty((B, A), dtype=torch.int32, device=h.device)
    if B == 0 or A == 0:
        return scores, ids
    lib = _build.load('similarity')
    fn = (lib.yc_similarity_bf16 if h.dtype == torch.bfloat16
          else lib.yc_similarity_f32)
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    ins = [t.contiguous() for t in (h, tp, cb, kernel, bias)]
    err = fn(*(t.data_ptr() for t in ins), scores.data_ptr(), ids.data_ptr(),
             B, A, Kd, C, E, nvalid,
             torch.cuda.current_stream(h.device).cuda_stream)
    _build.check(lib, err, 'similarity kernel launch')
    launches += 1
    return scores, ids


def fused_projected_similarity_argmax(h: torch.Tensor, text: torch.Tensor,
                                      kernel: torch.Tensor,
                                      bias: torch.Tensor,
                                      num_valid: Optional[int] = None
                                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """h (A, Kd) or (B, A, Kd) raw hidden activations in the compute dtype;
    text (C, E) or (B, C, E), L2-normalised (per image after I-Pool: never
    pass text[0] for a batch); kernel (Kd, E), bias (E,) fp32.
    Returns (scores float32, class_ids int32) shaped (A,) or (B, A)."""
    squeeze = h.dim() == 2
    if squeeze:
        h = h[None]
    if text.dim() == 2:
        text = text[None].expand(h.shape[0], -1, -1)
    if h.device.type == 'cpu':
        s, i = similarity_argmax_plain(h, text, kernel, bias, num_valid)
    elif h.device.type == 'cuda':
        tp, cb = _fold_text(text, kernel, bias, h.dtype)
        nvalid = text.shape[1] if num_valid is None else int(num_valid)
        s, i = _launch(h, tp, cb, kernel.to(h.dtype), bias.float(), nvalid)
    else:
        raise RuntimeError(f'no similarity kernel for device {h.device}')
    return (s[0], i[0]) if squeeze else (s, i)


def similarity_argmax_reference_plain(obj: torch.Tensor, text: torch.Tensor,
                                      num_valid: Optional[int] = None,
                                      normalize_obj: bool = False
                                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The unprojected algebra in PyTorch ops: matmul, then the masked
    max/argmax, then the norm divide. obj (B, A, E); text (B, C, E) cast
    to obj's dtype. Returns scores (B, A) float32 and ids (B, A) int32."""
    of = obj.float()
    raw = torch.matmul(of, text.to(obj.dtype).float().transpose(1, 2))
    best, ids = _masked_max(raw, num_valid)
    if normalize_obj:
        best = best / torch.linalg.vector_norm(of, dim=-1).clamp_min(1e-12)
    return best, ids.to(torch.int32)


def _launch_unprojected(obj: torch.Tensor, text: torch.Tensor, nvalid: int,
                        normalize_obj: bool
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    global unprojected_launches
    B, A, E = obj.shape
    C = text.shape[1]
    if obj.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f'similarity kernel takes float32 or bfloat16, '
                        f'got {obj.dtype}')
    if E % 32 or E > 512:
        raise ValueError(f'unprojected similarity kernel needs E % 32 == 0 '
                         f'and E <= 512 (got {E})')
    if text.shape != (B, C, E):
        raise ValueError(f'text {tuple(text.shape)} does not match obj '
                         f'{tuple(obj.shape)}')
    scores = torch.empty((B, A), dtype=torch.float32, device=obj.device)
    ids = torch.empty((B, A), dtype=torch.int32, device=obj.device)
    if B == 0 or A == 0:
        return scores, ids
    lib = _build.load('similarity')
    fn = (lib.yc_similarity_unprojected_bf16 if obj.dtype == torch.bfloat16
          else lib.yc_similarity_unprojected_f32)
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    ins = [obj.contiguous(), text.to(obj.dtype).contiguous()]
    err = fn(*(t.data_ptr() for t in ins), scores.data_ptr(), ids.data_ptr(),
             B, A, E, C, nvalid, int(normalize_obj),
             torch.cuda.current_stream(obj.device).cuda_stream)
    _build.check(lib, err, 'unprojected similarity kernel launch')
    unprojected_launches += 1
    return scores, ids


def fused_similarity_argmax(obj: torch.Tensor, text: torch.Tensor,
                            num_valid: Optional[int] = None,
                            normalize_obj: bool = False
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """obj (A, E) or (B, A, E), pre-normalised unless normalize_obj; text
    (C, E) shared or (B, C, E) per image, L2-normalised. fp32 or bf16.
    Returns (scores float32, class_ids int32) shaped (A,) or (B, A)."""
    squeeze = obj.dim() == 2
    if squeeze:
        obj = obj[None]
    if text.dim() == 2:
        text = text[None].expand(obj.shape[0], -1, -1)
    if obj.device.type == 'cpu':
        s, i = similarity_argmax_reference_plain(obj, text, num_valid,
                                                 normalize_obj)
    elif obj.device.type == 'cuda':
        nvalid = text.shape[1] if num_valid is None else int(num_valid)
        s, i = _launch_unprojected(obj, text, nvalid, normalize_obj)
    else:
        raise RuntimeError(f'no similarity kernel for device {obj.device}')
    return (s[0], i[0]) if squeeze else (s, i)
