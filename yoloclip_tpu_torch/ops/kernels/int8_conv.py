"""The int8 conv of an eligible ConvBlock in the W8A8 deploy graph: CUDA
kernel + plain version.

Replaces the XLA int8 convolution of `yoloclip_tpu/models/layers.py:260-274`
(`ConvBlock`, quant='int8': quantize the input, `conv_general_dilated` on
int8 operands with `preferred_element_type=int32`, dequant + bias + SiLU).
There is no Pallas kernel behind it; eager PyTorch has no int8 convolution
on CUDA. For x (B, Cin, H, W) in channels_last memory (NHWC), fp32 or bf16,
int8 `wq` (Cout, 3, 3, Cin), fp32 `wscale` and `qbias` (Cout,), a 0-d fp32
`act_scale` and stride 1 or 2 (padding 1):

    q   = clamp(round_half_even(x / act_scale), -127, 127)     int8
    acc = conv(q, wq)                                          exact int32
    y   = silu(float(acc) * (wscale * act_scale) + qbias)      in x's dtype

returned as (B, Cout, Ho, Wo) channels_last. With epilogue=False the raw
int32 accumulator comes back instead (the bit-exactness check only).

`int8_conv` checks its arguments and calls the custom op
`yoloclip::int8_conv` (`ops/kernels/library.py`), which runs
`int8_conv_plain` for CPU tensors and the CUDA kernel (`csrc/int8_conv.cu`)
for CUDA tensors; it never swaps one for the other.
The plain version quantizes with torch.round, convolves in float64, where
every sum of int8 products is exact (at most 9 * Cin * 127^2, 37 M at
Cin = 256, past fp32's 2^24), and applies the same epilogue, each
operation rounded on its own; the kernel quantizes to exactly what IEEE
division and ties-to-even rounding give and rounds each epilogue
operation on its own too, so its accumulator is bit-identical and its
pre-SiLU value equal to the plain version's. The kernel (an s8 wgmma
implicit GEMM: each block quantizes its tile's input halo once into
shared memory, then runs all 9 taps of up to 256 output channels from
it) is one launch a call.
"""

from __future__ import annotations

import ctypes
import threading

import torch
import torch.nn.functional as F

from yoloclip_tpu_torch import _build
from yoloclip_tpu_torch.ops.kernels import library

# Launches of the CUDA kernel (incremented only where it launches); the
# bf16-input launches are also counted apart.
launches = 0
launches_bf16 = 0
_count_lock = threading.Lock()   # shards on threads launch too

_lib_fns = None


def quantize_plain(x: torch.Tensor, act_scale: torch.Tensor) -> torch.Tensor:
    """x (any float dtype) -> int8 q = clamp(round(x / act_scale), +-127),
    the division in fp32, ties to even (as jnp.round)."""
    q = torch.round(x.float() / act_scale.float())
    return torch.clamp(q, -127, 127).to(torch.int8)


def int8_conv_plain(x: torch.Tensor, wq: torch.Tensor, wscale: torch.Tensor,
                    qbias: torch.Tensor, act_scale: torch.Tensor, stride: int,
                    epilogue: bool = True) -> torch.Tensor:
    """The plain PyTorch version of `int8_conv` (same arguments)."""
    k = wq.shape[1]
    q = quantize_plain(x, act_scale)
    w = wq.permute(0, 3, 1, 2)                       # (Cout, Cin, kh, kw)
    acc = F.conv2d(q.double(), w.double(), None, stride, k // 2).to(
        torch.int32)
    if not epilogue:
        return acc.contiguous(memory_format=torch.channels_last)
    scale = wscale.float() * act_scale.float()
    y = acc.float() * scale[:, None, None] + qbias.float()[:, None, None]
    return F.silu(y).to(x.dtype).contiguous(memory_format=torch.channels_last)


def _fns():
    """The loaded library and its two C launchers, argtypes set once."""
    global _lib_fns
    if _lib_fns is None:
        lib = _build.load('int8_conv')
        fns = {}
        for dt, sym in ((torch.float32, 'yc_int8_conv_f32'),
                        (torch.bfloat16, 'yc_int8_conv_bf16')):
            fn = getattr(lib, sym)
            # x, wq, wscale, qbias, act_scale, out, B, H, W, Cin, Cout,
            # stride, epilogue, stream
            fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
            fns[dt] = fn
        _lib_fns = (lib, fns)
    return _lib_fns


def _check(x: torch.Tensor, wq: torch.Tensor, wscale: torch.Tensor,
           qbias: torch.Tensor, act_scale: torch.Tensor, stride: int) -> None:
    if x.dim() != 4:
        raise ValueError(f'int8 conv takes x (B, Cin, H, W), got '
                         f'{tuple(x.shape)}')
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f'int8 conv takes fp32 or bf16 input, got {x.dtype}')
    cout, kh, kw, cin = wq.shape
    if wq.dtype != torch.int8 or (kh, kw) != (3, 3) or cin != x.shape[1]:
        raise ValueError(f'int8 conv takes int8 wq (Cout, 3, 3, {x.shape[1]})'
                         f', got {wq.dtype} {tuple(wq.shape)}')
    if cin % 16 or cout % 8:
        raise ValueError(f'int8 conv takes Cin % 16 == 0 and Cout % 8 == 0, '
                         f'got Cin={cin}, Cout={cout}')
    if stride not in (1, 2):
        raise ValueError(f'int8 conv takes stride 1 or 2, got {stride}')
    for name, t, shape in (('wscale', wscale, (cout,)),
                           ('qbias', qbias, (cout,)),
                           ('act_scale', act_scale, ())):
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f'int8 conv takes fp32 {name} {shape}, got '
                             f'{t.dtype} {tuple(t.shape)}')
    for t in (wq, wscale, qbias, act_scale):
        if t.device != x.device:
            raise ValueError(f'int8 conv operands on {t.device} and '
                             f'{x.device}')


def _aligned(t: torch.Tensor, memory_format=torch.contiguous_format):
    """t contiguous in `memory_format` on a 16-byte boundary (the kernel
    reads 16 bytes a load); copied only when it is not both already."""
    t = t.contiguous(memory_format=memory_format)
    return t if t.data_ptr() % 16 == 0 else t.clone(
        memory_format=memory_format)


def _new_out(x: torch.Tensor, wq: torch.Tensor, stride: int,
             epilogue: bool) -> torch.Tensor:
    """The kernel's uninitialised output, (B, Cout, Ho, Wo) channels_last;
    also the op's fake."""
    B, _, H, W = x.shape
    return torch.empty(
        (B, wq.shape[0], (H - 1) // stride + 1, (W - 1) // stride + 1),
        dtype=x.dtype if epilogue else torch.int32, device=x.device,
        memory_format=torch.channels_last)


def _launch(x, wq, wscale, qbias, act_scale, stride, epilogue):
    global launches, launches_bf16
    lib, fns = _fns()
    B, cin, H, W = x.shape
    cout = wq.shape[0]
    out = _new_out(x, wq, stride, epilogue)
    if out.numel() == 0:
        return out
    x = _aligned(x, torch.channels_last)
    wq = _aligned(wq)
    err = fns[x.dtype](x.data_ptr(), wq.data_ptr(), wscale.data_ptr(),
                       qbias.data_ptr(), act_scale.data_ptr(),
                       out.data_ptr(), B, H, W, cin, cout, stride,
                       int(epilogue),
                       torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, 'int8 conv kernel launch')
    with _count_lock:
        launches += 1
        launches_bf16 += x.dtype == torch.bfloat16
    return out


def _conv_fake(x, wq, wscale, qbias, act_scale, stride, epilogue):
    return _new_out(x, wq, stride, epilogue)


CONV_OP = library.KernelOp(
    'int8_conv', 'int8 conv',
    '(Tensor x, Tensor wq, Tensor wscale, Tensor qbias, Tensor act_scale, '
    'int stride, bool epilogue) -> Tensor',
    int8_conv_plain, _launch, _conv_fake)


def int8_conv(x: torch.Tensor, wq: torch.Tensor, wscale: torch.Tensor,
              qbias: torch.Tensor, act_scale: torch.Tensor, stride: int,
              epilogue: bool = True) -> torch.Tensor:
    """x (B, Cin, H, W) fp32/bf16, channels_last; wq int8 (Cout, 3, 3,
    Cin); wscale, qbias fp32 (Cout,); act_scale 0-d fp32; stride 1 or 2 ->
    silu(dequantized conv + qbias) (B, Cout, Ho, Wo) in x's dtype,
    channels_last (int32 accumulator with epilogue=False)."""
    _check(x, wq, wscale, qbias, act_scale, stride)
    return CONV_OP(x, wq, wscale, qbias, act_scale, int(stride),
                   bool(epilogue))
