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

Folded raw (`normalize=False`, YOLO-World's BatchNorm contrastive head): the
same max and argmax of (h K + b) . t, not divided by the row norm, so the
kernel skips the norm's h K product altogether. Plain version:
`similarity_max_plain`.

Unprojected: `fused_similarity_argmax` replaces
`yoloclip_tpu/ops/pallas/similarity.py::fused_similarity_argmax`. For
already-projected rows obj and L2-normalised text t it returns the max and
lowest argmax of obj . t over c < num_valid, the max divided by
max(||obj||, 1e-12) when normalize_obj is set, without materialising
(B, A, C). Plain version: `similarity_argmax_reference_plain`.

Each mode is a custom op (`ops/kernels/library.py`):
`yoloclip::fused_projected_similarity_argmax`,
`yoloclip::fused_projected_similarity_max` (folded raw) and
`yoloclip::fused_similarity_argmax`, whose cpu implementation is the plain
version and whose cuda implementation the kernel; the wrappers call them,
so each runs its plain version for CPU tensors and the CUDA kernel for
CUDA tensors, and never swaps one for the other. The kernel runs both
products on the tensor cores: bf16 as it is, fp32 as 3xTF32 (each operand
split into TF32 high and low parts inside the kernel).

Over a class shard (the 'model' axis, `parallel/collectives.py::ClassShard`):
`sharded_projected_similarity_argmax` and `sharded_similarity_argmax` run
the same wrapper on the shard's block of the text with the shard's own
num_valid, clamp(num_valid - offset, 0, size) -- 0 where the block is all
padding, when the kernel returns its masked NEG score and id 0 -- and merge
the shards' (score, id) pairs: the max, ties to the lowest global id.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import torch

from yoloclip_tpu_torch import _build
from yoloclip_tpu_torch.ops.kernels import library, register_counters
from yoloclip_tpu_torch.parallel.collectives import ClassShard, merge_argmax

NEG = -1e30

# Launches of the CUDA kernel, folded, folded raw and unprojected mode,
# and of their bf16 instantiations among them (incremented only where each
# launches).
launches = 0
launches_bf16 = 0
unprojected_launches = 0
unprojected_launches_bf16 = 0
raw_launches = 0
raw_launches_bf16 = 0
_count_lock = threading.Lock()   # shards on threads launch too
register_counters(__name__, _count_lock,
                  ('launches', 'launches_bf16', 'unprojected_launches',
                   'unprojected_launches_bf16', 'raw_launches',
                   'raw_launches_bf16'))


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


def similarity_max_plain(h: torch.Tensor, text: torch.Tensor,
                         kernel: torch.Tensor, bias: torch.Tensor,
                         num_valid: Optional[int] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The folded raw algebra in PyTorch ops: the max and lowest argmax
    over c < num_valid of h . tp + cb (tp, cb as `_fold_text` makes them),
    not divided by any norm. Shapes and dtypes as
    `similarity_argmax_plain`."""
    tp, cb = _fold_text(text, kernel, bias, h.dtype)
    raw = torch.matmul(h.float(), tp.float().transpose(1, 2)) + cb[:, None, :]
    best, ids = _masked_max(raw, num_valid)
    return best, ids.to(torch.int32)


def _prepare_folded(dtype: torch.dtype, text: torch.Tensor,
                    kernel: torch.Tensor, bias: torch.Tensor) -> dict:
    """Host-side operands of the folded kernel, built once per call: tp
    and cb as `_fold_text` makes them, and K^T (E, Kd) in `dtype`, so that
    both products read a K-major B operand."""
    kd = kernel.to(dtype)    # cast once: `_fold_text` then casts nothing
    tp, cb = _fold_text(text, kd, bias, dtype)
    # The model's K is a transposed view of the conv weight (E, Kd), so
    # this transpose is usually free.
    return dict(tp=tp, cb=cb, kt=kd.t().contiguous(), bias=bias.float())


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous, on a 16-byte boundary (the kernel copies 16 bytes at a
    time)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check_dtype(dtype: torch.dtype) -> None:
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f'similarity kernel takes float32 or bfloat16, '
                        f'got {dtype}')


_ARGTYPES = {
    'folded': [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
    'raw': [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
    'unprojected': [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
    + [ctypes.c_void_p],
}
_fns: dict = {}


def _fn(mode: str, dtype: torch.dtype):
    """The C launcher of `mode` for `dtype`, its argtypes set once per
    process."""
    key = (mode, dtype)
    if key not in _fns:
        lib = _build.load('similarity')
        name = ('yc_similarity_' + ('' if mode == 'folded' else mode + '_')
                + ('bf16' if dtype == torch.bfloat16 else 'f32'))
        fn = getattr(lib, name)
        fn.argtypes = _ARGTYPES[mode]
        fn.restype = ctypes.c_int
        _fns[key] = (lib, fn)
    return _fns[key]


def _launch(h: torch.Tensor, ops: dict, C: int, E: int, nvalid: int,
            mode: str = 'folded') -> Tuple[torch.Tensor, torch.Tensor]:
    """h (B, A, Kd); `ops` from `_prepare_folded`; mode 'folded' or 'raw'
    (the max not divided by ||h K + b||)."""
    global launches, launches_bf16, raw_launches, raw_launches_bf16
    B, A, Kd = h.shape
    _check_dtype(h.dtype)
    if Kd % 128 or not 0 < Kd <= 256 or E % 128 or E <= 0:
        raise ValueError(f'similarity kernel needs hidden % 128 == 0, '
                         f'hidden <= 256 and E % 128 == 0 (got {Kd}, {E})')
    if C < 1:
        raise ValueError(f'similarity kernel needs C >= 1 (got {C})')
    scores = torch.empty((B, A), dtype=torch.float32, device=h.device)
    ids = torch.empty((B, A), dtype=torch.int32, device=h.device)
    if B == 0 or A == 0:
        return scores, ids
    lib, fn = _fn(mode, h.dtype)
    ins = [_aligned(t) for t in (h, ops['tp'], ops['cb'], ops['kt'],
                                 ops['bias'])]
    err = fn(*(t.data_ptr() for t in ins),
             scores.data_ptr(), ids.data_ptr(), B, A, Kd, C, E, nvalid,
             torch.cuda.current_stream(h.device).cuda_stream)
    _build.check(lib, err, 'similarity kernel launch')
    with _count_lock:
        if mode == 'raw':
            raw_launches += 1
            raw_launches_bf16 += h.dtype == torch.bfloat16
        else:
            launches += 1
            launches_bf16 += h.dtype == torch.bfloat16
    return scores, ids


def _folded_cuda(h: torch.Tensor, text: torch.Tensor, kernel: torch.Tensor,
                 bias: torch.Tensor, num_valid: Optional[int]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    ops = _prepare_folded(h.dtype, text, kernel, bias)
    nvalid = text.shape[1] if num_valid is None else num_valid
    return _launch(h, ops, text.shape[1], kernel.shape[1], nvalid)


def _folded_raw_cuda(h: torch.Tensor, text: torch.Tensor,
                     kernel: torch.Tensor, bias: torch.Tensor,
                     num_valid: Optional[int]
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    ops = _prepare_folded(h.dtype, text, kernel, bias)
    nvalid = text.shape[1] if num_valid is None else num_valid
    return _launch(h, ops, text.shape[1], kernel.shape[1], nvalid, 'raw')


def _rows_fake(rows: torch.Tensor, *_) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, A) float32 scores and int32 ids of rows (B, A, D)."""
    shape = rows.shape[:2]
    return (rows.new_empty(shape, dtype=torch.float32),
            rows.new_empty(shape, dtype=torch.int32))


FOLDED_OP = library.KernelOp(
    'fused_projected_similarity_argmax', 'similarity',
    '(Tensor h, Tensor text, Tensor kernel, Tensor bias, int? num_valid) '
    '-> (Tensor, Tensor)', similarity_argmax_plain, _folded_cuda, _rows_fake)


RAW_OP = library.KernelOp(
    'fused_projected_similarity_max', 'similarity',
    '(Tensor h, Tensor text, Tensor kernel, Tensor bias, int? num_valid) '
    '-> (Tensor, Tensor)', similarity_max_plain, _folded_raw_cuda,
    _rows_fake)


def fused_projected_similarity_argmax(h: torch.Tensor, text: torch.Tensor,
                                      kernel: torch.Tensor,
                                      bias: torch.Tensor,
                                      num_valid: Optional[int] = None,
                                      normalize: bool = True
                                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """h (A, Kd) or (B, A, Kd) raw hidden activations in the compute dtype;
    text (C, E) or (B, C, E), L2-normalised (per image after I-Pool: never
    pass text[0] for a batch); kernel (Kd, E), bias (E,) fp32.
    normalize=False: the folded raw mode, the max of (h K + b) . t not
    divided by ||h K + b||.
    Returns (scores float32, class_ids int32) shaped (A,) or (B, A)."""
    squeeze = h.dim() == 2
    if squeeze:
        h = h[None]
    if text.dim() == 2:
        text = text[None].expand(h.shape[0], -1, -1)
    op = FOLDED_OP if normalize else RAW_OP
    s, i = op(h, text, kernel, bias,
              None if num_valid is None else int(num_valid))
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
    global unprojected_launches, unprojected_launches_bf16
    B, A, E = obj.shape
    C = text.shape[1]
    _check_dtype(obj.dtype)
    if E % 128 or not 0 < E <= 512:
        raise ValueError(f'unprojected similarity kernel needs E % 128 == 0 '
                         f'and E <= 512 (got {E})')
    if text.shape != (B, C, E) or C < 1:
        raise ValueError(f'text {tuple(text.shape)} does not match obj '
                         f'{tuple(obj.shape)} (or has no class)')
    scores = torch.empty((B, A), dtype=torch.float32, device=obj.device)
    ids = torch.empty((B, A), dtype=torch.int32, device=obj.device)
    if B == 0 or A == 0:
        return scores, ids
    lib, fn = _fn('unprojected', obj.dtype)
    ins = [_aligned(obj), _aligned(text.to(obj.dtype))]
    err = fn(*(t.data_ptr() for t in ins),
             scores.data_ptr(), ids.data_ptr(), B, A, E, C, nvalid,
             int(normalize_obj),
             torch.cuda.current_stream(obj.device).cuda_stream)
    _build.check(lib, err, 'unprojected similarity kernel launch')
    with _count_lock:
        unprojected_launches += 1
        unprojected_launches_bf16 += obj.dtype == torch.bfloat16
    return scores, ids


def _unprojected_cuda(obj: torch.Tensor, text: torch.Tensor,
                      num_valid: Optional[int], normalize_obj: bool
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    nvalid = text.shape[1] if num_valid is None else num_valid
    return _launch_unprojected(obj, text, nvalid, normalize_obj)


UNPROJECTED_OP = library.KernelOp(
    'fused_similarity_argmax', 'similarity',
    '(Tensor obj, Tensor text, int? num_valid, bool normalize_obj) '
    '-> (Tensor, Tensor)', similarity_argmax_reference_plain,
    _unprojected_cuda, _rows_fake)


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
    s, i = UNPROJECTED_OP(obj, text,
                          None if num_valid is None else int(num_valid),
                          bool(normalize_obj))
    return (s[0], i[0]) if squeeze else (s, i)


def shard_num_valid(num_valid: Optional[int], shard: ClassShard) -> int:
    """A shard's count of valid classes: clamp(num_valid - offset, 0,
    size), num_valid None meaning every class."""
    nv = shard.total if num_valid is None else int(num_valid)
    return max(0, min(nv - shard.offset, shard.size))


def _over_shard(launch, rows: torch.Tensor, shard: ClassShard,
                num_valid: Optional[int]):
    """Run launch(num_valid) on the shard's block (an empty block launches
    nothing: NEG and id 0), then merge over the model axis."""
    if shard.size:
        s, i = launch(shard_num_valid(num_valid, shard))
    else:
        s = torch.full(rows.shape[:-1], NEG, dtype=torch.float32,
                       device=rows.device)
        i = torch.zeros(rows.shape[:-1], dtype=torch.int32,
                        device=rows.device)
    return merge_argmax(s, i, shard.offset, shard.group)


def sharded_projected_similarity_argmax(h: torch.Tensor, text: torch.Tensor,
                                        kernel: torch.Tensor,
                                        bias: torch.Tensor,
                                        shard: ClassShard,
                                        num_valid: Optional[int] = None
                                        ) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """`fused_projected_similarity_argmax` over a class shard: text is
    this shard's block (size, E) or (B, size, E); num_valid counts GLOBAL
    classes. Returns the global (scores, class_ids), the same on every
    shard."""
    return _over_shard(
        lambda nv: fused_projected_similarity_argmax(h, text, kernel, bias,
                                                     nv), h, shard,
        num_valid)


def sharded_similarity_argmax(obj: torch.Tensor, text: torch.Tensor,
                              shard: ClassShard,
                              num_valid: Optional[int] = None,
                              normalize_obj: bool = False
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`fused_similarity_argmax` over a class shard (as
    `sharded_projected_similarity_argmax`)."""
    return _over_shard(
        lambda nv: fused_similarity_argmax(obj, text, nv, normalize_obj),
        obj, shard, num_valid)
