"""Shared building blocks. Counterpart of `yoloclip_tpu/models/layers.py`.

Tensors are NCHW in channels_last memory format. Module and parameter names
follow the reference torch layout that `utils/convert.py::build_key_map`
spells out, so converted weights load with strict=True.

`ConvBlock` has the JAX package's forms: the float conv + BatchNorm + SiLU
(optionally as a space-to-depth stem, `s2d`/`s2d_pre`), and, in the W8A8
deploy graph (`quant='int8'`, `ops/quantize.py`), the BN-folded float conv
{wf, fbias} or, for a block that passes `quant_eligible`, the int8 conv
{wq, wscale, qbias, act_scale} through the hand-written kernel
(`ops/kernels/int8_conv.py`). The JAX package's int8-stored `QT` edges are
not ported: they are off at its default threshold. BatchNorm trains by
flax's rule (`BatchNorm2d`).
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from yoloclip_tpu_torch.ops.kernels.int8_conv import int8_conv

# W8A8 eligibility thresholds, copied from the JAX package (measured there
# on v5e: int8 wins on wide 3x3 convs and loses on narrow and 1x1 ones).
INT8_MIN_CH = 64
INT8_MAX_CH = 128


def quant_eligible(kernel_size: int, cin: int, cout: int) -> bool:
    """True: the block runs as an s8 x s8 -> s32 conv in the int8 deploy
    graph; False: as a BN-folded float conv. `ops/quantize.py` and
    `ConvBlock` key off this one predicate."""
    return (kernel_size == 3 and min(cin, cout) >= INT8_MIN_CH
            and max(cin, cout) >= INT8_MAX_CH)


def space_to_depth2(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/2, W/2, 4C); channel index = (a*2+b)*C + c
    for intra-block offsets (a, b). H and W must be even."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // 2, 2, W // 2, 2, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H // 2, W // 2, 4 * C)


# di -> (kh, a): input row 2i + di - 1 lives in s2d row i - 1 + kh at
# intra-block offset a; columns likewise.
_KH_A = {0: (0, 1), 1: (1, 0), 2: (1, 1)}


@functools.lru_cache(maxsize=16)
def _s2d_index(C: int) -> np.ndarray:
    """(2, 2, 4C) rows of the (9C + 1)-row table [w3 taps; zero row] that
    make up the 2x2 kernel; 9C points at the zero row."""
    idx = np.full((2, 2, 4 * C), 9 * C, np.int64)
    for di in range(3):
        kh, a = _KH_A[di]
        for dj in range(3):
            kw, b = _KH_A[dj]
            ch = (a * 2 + b) * C
            idx[kh, kw, ch:ch + C] = (di * 3 + dj) * C + np.arange(C)
    return idx


def s2d_kernel3(w3: torch.Tensor) -> torch.Tensor:
    """A 3x3/stride-2 kernel (3, 3, C, O) -> the exactly equivalent 2x2/
    stride-1 kernel (2, 2, 4C, O) over the space-to-depth layout, to be
    used with padding ((1, 0), (1, 0)). 7 of the 16 (kh, kw, a, b) taps
    are structurally zero."""
    _, _, C, O = w3.shape
    table = torch.cat([w3.reshape(9 * C, O), w3.new_zeros((1, O))])
    idx = torch.from_numpy(_s2d_index(C)).to(w3.device)
    return table[idx]


class _ConvKernel(nn.Module):
    """A bare conv kernel `weight` (O, I, k, k) under nn.Conv2d's key, for
    the stems that rewrite their kernel before the conv. It stays fp32
    (the compute-dtype cast skips it) and is cast at use, as in the JAX
    package."""

    def __init__(self, cin: int, cout: int, kernel_size: int):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(cout, cin, kernel_size, kernel_size))


class BatchNorm2d(nn.BatchNorm2d):
    """nn.BatchNorm2d (eps 1e-5) whose train mode follows flax's
    `BatchNorm(momentum=0.9)`, as the JAX package trains: it normalises
    with the biased batch statistics (as torch does) and updates the
    running buffers as ra = 0.9 ra + 0.1 batch_stat with the BIASED batch
    variance (torch's own update uses the unbiased one), the statistics
    reduced in fp32 whatever the input dtype. Eval mode is nn.BatchNorm2d's;
    `num_batches_tracked` stays as loaded."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        with torch.no_grad():
            var, mean = torch.var_mean(x.float(), dim=(0, 2, 3),
                                       correction=0)
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
            self.running_var.mul_(1.0 - m).add_(var, alpha=m)
        return F.batch_norm(x, None, None, self.weight, self.bias, True,
                            0.0, self.eps)


class ConvBlock(nn.Module):
    """Conv (no bias, padding k//2) + BatchNorm (eps 1e-5) + SiLU.

    s2d: a 3x3/stride-2 block runs as the exactly equivalent 2x2/stride-1
    conv over the space-to-depth input (`s2d_kernel3`). s2d_pre: the input
    arrives already space-to-depth'd as a 0..255 canvas (B, 4C, H/2, W/2)
    and the /255 folds into the fp32 kernel before its one cast. Both keep
    the canonical (O, C, 3, 3) kernel.

    quant='int8' (the deploy graph): a block passing `quant_eligible`
    carries int8 `wq` (Cout, kh, kw, Cin), fp32 `wscale` and `qbias`
    (Cout,) and a 0-d fp32 `act_scale`, and runs quantize -> s8 x s8 ->
    s32 conv -> dequant + bias + SiLU in one kernel launch; any other block
    carries the BN-folded fp32 kernel `wf` (Cout, Cin, k, k) and `fbias`,
    and runs conv, + fbias in fp32, SiLU, a cast to the compute dtype.
    Both keep float in, float out."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 3,
                 stride: int = 1, quant: str = 'none', s2d: bool = False,
                 s2d_pre: bool = False):
        super().__init__()
        if s2d and s2d_pre:
            raise ValueError('s2d and s2d_pre are mutually exclusive')
        if (s2d or s2d_pre) and (kernel_size, stride) != (3, 2):
            raise ValueError(
                's2d/s2d_pre require kernel_size=3, stride=2 (got k=%d, '
                's=%d)' % (kernel_size, stride))
        self.stride, self.pad = stride, kernel_size // 2
        self.s2d, self.s2d_pre = s2d, s2d_pre
        if quant == 'none':
            self.mode = 'float'
            self.conv = (_ConvKernel(cin, cout, kernel_size)
                         if s2d or s2d_pre else
                         nn.Conv2d(cin, cout, kernel_size, stride, self.pad,
                                   bias=False))
            self.bn = BatchNorm2d(cout)
        elif quant == 'int8' and quant_eligible(kernel_size, cin, cout):
            # the wq path has no s2d rewrite; the stem never gets here
            # (cin = 3 fails quant_eligible): keep that explicit
            assert not (s2d or s2d_pre), \
                's2d/s2d_pre blocks must not take the int8 wq path'
            self.mode = 'int8'
            self.register_buffer('wq', torch.zeros(
                cout, kernel_size, kernel_size, cin, dtype=torch.int8))
            self.register_buffer('wscale', torch.ones(cout))
            self.register_buffer('qbias', torch.zeros(cout))
            self.register_buffer('act_scale', torch.ones(()))
        elif quant == 'int8':
            self.mode = 'folded'
            self.wf = nn.Parameter(
                torch.zeros(cout, cin, kernel_size, kernel_size))
            self.fbias = nn.Parameter(torch.zeros(cout))
        else:
            raise ValueError(f"ConvBlock quant must be 'none' or 'int8', "
                             f'got {quant!r}')

    def _conv(self, x: torch.Tensor, w: torch.Tensor,
              bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x channels_last; w (O, C, k, k) in x's dtype."""
        if not (self.s2d or self.s2d_pre):
            return F.conv2d(x, w, bias, self.stride, self.pad)
        if self.s2d:
            x = space_to_depth2(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        w2 = s2d_kernel3(w.permute(2, 3, 1, 0)).permute(3, 2, 0, 1)
        x = F.pad(x, (1, 0, 1, 0)).contiguous(
            memory_format=torch.channels_last)
        return F.conv2d(x, w2, bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.mode == 'int8':
            return int8_conv(x, self.wq, self.wscale, self.qbias,
                             self.act_scale, self.stride)
        dt = x.dtype
        if self.mode == 'folded':
            w = self.wf * (1.0 / 255.0) if self.s2d_pre else self.wf
            w = w.to(dt)
            if dt == torch.float32:
                return F.silu(self._conv(x, w, self.fbias))
            # the conv's output + fbias in fp32, one cast at the end
            return F.silu(self._conv(x, w) + self.fbias[:, None, None]).to(dt)
        w = self.conv.weight
        if self.s2d_pre:
            w = w * (1.0 / 255.0)
        return F.silu(self.bn(self._conv(x, w.to(dt))))


class DarkBottleneck(nn.Module):
    """1x1 squeeze to c/2 -> 3x3 expand to c; residual when the input
    already has c channels and shortcut=True."""

    def __init__(self, cin: int, cout: int, shortcut: bool = True,
                 quant: str = 'none'):
        super().__init__()
        self.cv1 = ConvBlock(cin, cout // 2, 1, quant=quant)
        self.cv2 = ConvBlock(cout // 2, cout, 3, quant=quant)
        self.add = shortcut and cin == cout

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class CSPLayer(nn.Module):
    """y1 = bottlenecks(cv1(x)); y2 = cv2(x); out = cv3(cat(y1, y2))."""

    def __init__(self, cin: int, cout: int, n_bottlenecks: int = 1,
                 quant: str = 'none'):
        super().__init__()
        c_ = cout // 2
        self.cv1 = ConvBlock(cin, c_, 1, quant=quant)
        self.cv2 = ConvBlock(cin, c_, 1, quant=quant)
        self.cv3 = ConvBlock(2 * c_, cout, 1, quant=quant)
        self.bottlenecks = nn.ModuleList(
            DarkBottleneck(c_, c_, True, quant) for _ in range(n_bottlenecks))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y1 = self.cv1(x)
        for m in self.bottlenecks:
            y1 = m(y1)
        return self.cv3(torch.cat([y1, self.cv2(x)], dim=1))


class SPPF(nn.Module):
    """cv1 to cin//2, three chained k x k max pools (stride 1, -inf
    padding), cat(x, y1, y2, y3), cv2."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 5,
                 quant: str = 'none'):
        super().__init__()
        c_ = cin // 2
        self.cv1 = ConvBlock(cin, c_, 1, quant=quant)
        self.cv2 = ConvBlock(4 * c_, cout, 1, quant=quant)
        self.k = kernel_size

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.cv1(x)
        p = self.k // 2
        y1 = F.max_pool2d(x, self.k, 1, p)
        y2 = F.max_pool2d(y1, self.k, 1, p)
        y3 = F.max_pool2d(y2, self.k, 1, p)
        return self.cv2(torch.cat([x, y1, y2, y3], dim=1))


class MultiHeadAttention(nn.Module):
    """torch.nn.MultiheadAttention's parameter layout (batch first, packed
    in_proj = [q; k; v], out_proj), computed as plain matmuls and softmax.
    The scores (accumulated in fp32) and the softmax are fp32 whatever the
    compute dtype."""

    def __init__(self, embed_dim: int, num_heads: int = 8):
        super().__init__()
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.in_proj_weight = nn.Parameter(nn.init.xavier_uniform_(
            torch.empty(3 * embed_dim, embed_dim)))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim))
        self.out_proj = nn.Linear(embed_dim, embed_dim)

    def forward(self, query: torch.Tensor, key: torch.Tensor,
                value: torch.Tensor,
                attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """attn_mask: optional additive (Lq, Lk) mask (e.g. causal -inf),
        added to the fp32 scores before the softmax."""
        E, H = self.embed_dim, self.num_heads
        hd = E // H
        wq, wk, wv = self.in_proj_weight.chunk(3, dim=0)
        bq, bk, bv = self.in_proj_bias.chunk(3, dim=0)
        B, Lq, _ = query.shape
        Lk = key.shape[1]
        q = F.linear(query, wq, bq).reshape(B, Lq, H, hd).transpose(1, 2)
        k = F.linear(key, wk, bk).reshape(B, Lk, H, hd).transpose(1, 2)
        v = F.linear(value, wv, bv).reshape(B, Lk, H, hd).transpose(1, 2)
        # fp32 scores from the compute-dtype operands (their products are
        # exact in fp32), as JAX's preferred_element_type=float32 einsum
        with torch.autocast(q.device.type, enabled=False):
            scores = torch.matmul(q.float(), k.float().transpose(2, 3))
        scores = scores / math.sqrt(hd)
        if attn_mask is not None:
            scores = scores + attn_mask.float()
        attn = torch.softmax(scores, dim=-1).to(v.dtype)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(B, Lq, E)
        return self.out_proj(out)
