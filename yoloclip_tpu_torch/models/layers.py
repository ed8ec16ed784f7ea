"""Shared building blocks. Counterpart of `yoloclip_tpu/models/layers.py`.

Tensors are NCHW in channels_last memory format. Module and parameter names
follow the reference torch layout that `utils/convert.py::build_key_map`
spells out, so converted weights load with strict=True.

`ConvBlock` has the JAX package's forms: the float conv + BatchNorm + SiLU
(optionally as a space-to-depth stem, `s2d`/`s2d_pre`), and, in the W8A8
deploy graph (`quant='int8'`, `ops/quantize.py`), the BN-folded float conv
{wf, fbias} or, for a block that passes `quant_eligible`, the int8 conv
{wq, wscale, qbias, act_scale} through the hand-written kernel
(`ops/kernels/int8_conv.py`). A block marked `store_out` may hand its
consumer an int8-stored edge (`QT`) instead of a float tensor, where the
edge is large enough (`store_int8_eligible`; off at the default
threshold, as in the JAX package). BatchNorm trains by
flax's rule (`BatchNorm2d`), over the global batch under data parallelism.
Under a height partition (`parallel/spatial.py`) every ConvBlock and
SPPF pool runs through `spatial.halo`: the unchanged op on its rows
extended by the neighbours' edge rows, cropped.
"""

from __future__ import annotations

import functools
import math
import os
from typing import Dict, NamedTuple, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from yoloclip_tpu_torch.ops.kernels.int8_conv import int8_conv
from yoloclip_tpu_torch.parallel import spatial
from yoloclip_tpu_torch.parallel.collectives import all_gather_stack


class QT(NamedTuple):
    """An int8-stored activation edge of the int8 deploy graph: `q` int8
    (B, C, H, W) channels_last, its 0-d fp32 dequantization `scale`, and
    the compute dtype the edge stands for (the port's blocks take their
    dtype from their input). A BN-folded consumer dequantizes on read
    (`as_float`); an int8 conv consumer reads `q` as it is, with `scale`
    in its epilogue in place of its own `act_scale`."""
    q: torch.Tensor
    scale: torch.Tensor
    dtype: torch.dtype


# Per-sample output elements (C H W) from which a `store_out` block stores
# its output as a QT edge: read at import from the same environment
# variable as the JAX package, with its default (off). The JAX package
# measured the stored edges as an end-to-end loss on v5e and keeps them for
# hardware where the trade may differ.
STORE_INT8_MIN_ELEMS = int(os.environ.get('YOLOCLIP_STORE_INT8_MIN_ELEMS',
                                          1 << 62))


def store_int8_eligible(h: int, w: int, c: int) -> bool:
    """Whether an (h, w, c) per-sample output is stored as int8: at least
    32 channels and STORE_INT8_MIN_ELEMS elements (the module global, read
    at call time)."""
    return c >= 32 and h * w * c >= STORE_INT8_MIN_ELEMS


def as_float(x: Union[torch.Tensor, QT], dtype: torch.dtype
             ) -> torch.Tensor:
    """A QT edge dequantized to `dtype` (q and scale each cast, then one
    product, rounded once), or a float tensor as it is."""
    if isinstance(x, QT):
        return x.q.to(dtype) * x.scale.to(dtype)
    return x


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
    return table[_s2d_index_on(C, w3.device)]


# (C, device) -> `_s2d_index(C)` on the device. The s2d stems rewrite
# their kernel on every forward, so the index is uploaded once and never
# evicted: a captured program (`inference/program.py`) reads it at a
# fixed address, and an upload inside a capture would raise.
_S2D_INDEX_ON: Dict[tuple, torch.Tensor] = {}


def _s2d_index_on(C: int, device: torch.device) -> torch.Tensor:
    idx = _S2D_INDEX_ON.get((C, device))
    if idx is None:    # setdefault: racing threads all get the first upload
        idx = _S2D_INDEX_ON.setdefault(
            (C, device), torch.from_numpy(_s2d_index(C)).to(device))
    return idx


class _ConvKernel(nn.Module):
    """A bare conv kernel `weight` (O, I, k, k) under nn.Conv2d's key, for
    the stems that rewrite their kernel before the conv. It stays fp32
    (the compute-dtype cast skips it) and is cast at use, as in the JAX
    package."""

    def __init__(self, cin: int, cout: int, kernel_size: int):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(cout, cin, kernel_size, kernel_size))


def at_least_fp32(x: torch.Tensor) -> torch.Tensor:
    """x in fp32, or float64 where it is (a float64 reference run: the
    fp32 islands of the model and the losses stay float64 there)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


class BatchNorm2d(nn.BatchNorm2d):
    """nn.BatchNorm2d (eps 1e-5) whose train mode follows flax's
    `BatchNorm(momentum=0.9)`, as the JAX package trains: it normalises
    with the biased batch statistics (as torch does) and updates the
    running buffers as ra = 0.9 ra + 0.1 batch_stat with the BIASED batch
    variance (torch's own update uses the unbiased one), the statistics
    reduced in fp32 for fp32, bf16 and fp16 input (float64 stays float64).
    Eval mode is nn.BatchNorm2d's;
    `num_batches_tracked` stays as loaded.

    `group` (set by `parallel/train_step.py` for a data-parallel step): the
    statistics are those of the GLOBAL batch, as flax's BatchNorm under the
    JAX package's sharded jit reduces them. Each rank's per-channel count,
    mean and sum of squared deviations (fp32) are gathered through a
    differentiable all-reduce and combined (Chan's parallel rule), so the
    backward all-reduces too. torch's SyncBatchNorm is not used: its update
    takes the unbiased variance (ROADMAP C5)."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=0.1)
        self.group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if self.group is not None:
            return self._synced(x)
        with torch.no_grad():
            var, mean = torch.var_mean(at_least_fp32(x), dim=(0, 2, 3),
                                       correction=0)
            self._update(mean, var)
        return F.batch_norm(x, None, None, self.weight, self.bias, True,
                            0.0, self.eps)

    def _update(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        m = self.momentum
        self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
        self.running_var.mul_(1.0 - m).add_(var, alpha=m)

    def _synced(self, x: torch.Tensor) -> torch.Tensor:
        xf = at_least_fp32(x)
        n = xf.numel() // xf.shape[1]
        var, mean = torch.var_mean(xf, dim=(0, 2, 3), correction=0)
        local = torch.stack([torch.full_like(mean, float(n)), mean,
                             var * n])
        counts, means, m2 = all_gather_stack(local, self.group).unbind(1)
        total = counts.sum(0)
        g_mean = (counts * means).sum(0) / total
        g_var = (m2.sum(0) + (counts * (means - g_mean) ** 2).sum(0)) / total
        with torch.no_grad():
            self._update(g_mean, g_var)
        shape = (1, -1, 1, 1)
        y = ((xf - g_mean.view(shape)) * torch.rsqrt(g_var + self.eps).view(
            shape) * self.weight.view(shape) + self.bias.view(shape))
        return y.to(x.dtype)


class ConvBlock(nn.Module):
    """Conv (no bias, padding k//2) + BatchNorm (eps 1e-5) + SiLU.

    s2d: a 3x3/stride-2 block runs as the exactly equivalent 2x2/stride-1
    conv over the space-to-depth input (`s2d_kernel3`). s2d_pre: the input
    arrives already space-to-depth'd as a 0..255 canvas (B, 4C, H/2, W/2)
    and the /255 folds into the fp32 kernel before its one cast. Both keep
    the canonical (O, C, 3, 3) kernel.

    act=False leaves the SiLU out (conv + BatchNorm only, YOLO-World's
    `act_cfg=None` blocks).

    quant='int8' (the deploy graph): a block passing `quant_eligible`
    carries int8 `wq` (Cout, kh, kw, Cin), fp32 `wscale` and `qbias`
    (Cout,) and a 0-d fp32 `act_scale`, and runs quantize -> s8 x s8 ->
    s32 conv -> dequant + bias + SiLU in one kernel launch (without SiLU,
    the kernel's int32 accumulator dequantized here); any other block
    carries the BN-folded fp32 kernel `wf` (Cout, Cin, k, k) and `fbias`,
    and runs conv, + fbias in fp32, SiLU, a cast to the compute dtype.

    Int8-stored edges (int8 graph only). A block built with store_out=True
    returns its output as a `QT` where `store_int8_eligible` holds for the
    output's per-sample (C, H, W), H the whole frame's under a height
    partition: clamp(round(y / out_scale), +-127) of the fp32 post-SiLU y,
    before any cast to the compute dtype. Its 0-d fp32 `out_scale` is an
    optional buffer, present where the loaded state dict holds it; an
    eligible output without it raises, naming the block. A QT input is
    dequantized on read by a BN-folded block and read as int8 by an int8
    conv block, its scale in place of `act_scale`."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 3,
                 stride: int = 1, quant: str = 'none', s2d: bool = False,
                 s2d_pre: bool = False, store_out: bool = False,
                 act: bool = True):
        super().__init__()
        self.act = act
        if s2d and s2d_pre:
            raise ValueError('s2d and s2d_pre are mutually exclusive')
        if (s2d or s2d_pre) and (kernel_size, stride) != (3, 2):
            raise ValueError(
                's2d/s2d_pre require kernel_size=3, stride=2 (got k=%d, '
                's=%d)' % (kernel_size, stride))
        self.k, self.stride, self.pad = kernel_size, stride, kernel_size // 2
        self.s2d, self.s2d_pre = s2d, s2d_pre
        # the block's name in its model, for error messages (YOLOCLIP
        # sets it)
        self.block_name = 'ConvBlock'
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
            # every store_out site is a 1x1 conv or the stem, so no int8
            # conv block stores its output (nor does one in JAX)
            assert not store_out, 'an int8 conv block stores no QT edge'
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
        # a store_out site: calibration records its output's range in the
        # float graph; a BN-folded block stores it in the int8 graph
        self.store_out = store_out
        if store_out and self.mode == 'folded':
            self.register_buffer('out_scale', None)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        # out_scale is in the state dict exactly where calibration found
        # the edge eligible: the buffer follows it
        if self.store_out and self.mode == 'folded':
            self.out_scale = (torch.ones(())
                              if prefix + 'out_scale' in state_dict
                              else None)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

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

    def forward(self, x: Union[torch.Tensor, QT]
                ) -> Union[torch.Tensor, QT]:
        # rows of the op (kernel, stride, padding above): s2d_pre's input
        # rows are space-to-depth rows, a 2x2 conv padded one row above
        rows = (2, 1, 1) if self.s2d_pre else (self.k, self.stride, self.pad)
        if isinstance(x, QT):
            # the halo rows of an int8 edge are int8; the scale is shared
            y = spatial.halo(
                lambda q: self._forward(QT(q, x.scale, x.dtype)), x.q, *rows)
        else:
            y = spatial.halo(self._forward, x, *rows)
        if self.store_out and self.mode == 'folded':
            return self._store(y, x.dtype)
        return y

    def _store(self, y: torch.Tensor, dt: torch.dtype
               ) -> Union[torch.Tensor, QT]:
        """The fp32 post-SiLU output y as a QT edge where eligible, else y
        in the compute dtype dt."""
        _, c, h, w = y.shape
        if not store_int8_eligible(spatial.global_rows(h), w, c):
            return y.to(dt)
        if self.out_scale is None:
            raise KeyError(f'ConvBlock {self.block_name}: its {c}x'
                           f'{spatial.global_rows(h)}x{w} output is an '
                           f'int8-stored edge at STORE_INT8_MIN_ELEMS='
                           f'{STORE_INT8_MIN_ELEMS}, but the state dict has '
                           'no out_scale for it (calibrate and quantize '
                           'with the same threshold)')
        q = torch.clamp(torch.round(y.float() / self.out_scale), -127, 127)
        return QT(q.to(torch.int8), self.out_scale, dt)

    def _silu(self, y: torch.Tensor) -> torch.Tensor:
        return F.silu(y) if self.act else y

    def _forward(self, x: Union[torch.Tensor, QT]) -> torch.Tensor:
        if self.mode == 'int8':
            q, scale, dt = ((x.q, x.scale, x.dtype) if isinstance(x, QT)
                            else (x, self.act_scale, x.dtype))
            if not self.act:
                acc = int8_conv(q, self.wq, self.wscale, self.qbias, scale,
                                self.stride, epilogue=False, out_dtype=dt)
                y = (acc.float() * (self.wscale * scale)[:, None, None]
                     + self.qbias[:, None, None])
                return y.to(dt)
            if isinstance(x, QT):
                return int8_conv(x.q, self.wq, self.wscale, self.qbias,
                                 x.scale, self.stride, out_dtype=x.dtype)
            return int8_conv(x, self.wq, self.wscale, self.qbias,
                             self.act_scale, self.stride)
        dt = x.dtype
        if self.mode == 'folded':
            x = as_float(x, dt)
            w = self.wf * (1.0 / 255.0) if self.s2d_pre else self.wf
            w = w.to(dt)
            if dt == torch.float32:
                return self._silu(self._conv(x, w, self.fbias))
            # the conv's output + fbias in fp32, one cast at the end (a
            # storing block quantizes the fp32 value: _store casts)
            y = self._silu(self._conv(x, w) + self.fbias[:, None, None])
            return y if self.store_out else y.to(dt)
        w = self.conv.weight
        if self.s2d_pre:
            w = w * (1.0 / 255.0)
        return self._silu(self.bn(self._conv(x, w.to(dt))))


class DarkBottleneck(nn.Module):
    """1x1 squeeze to c/2 -> 3x3 expand to c; residual when the input
    already has c channels and shortcut=True. cv1 -> cv2 is a ConvBlock ->
    ConvBlock edge, so a 1x1 cv1 may store it as int8.

    k1=3, expansion=1.0: the C2f blocks' bottleneck (3x3 -> 3x3 at c)."""

    def __init__(self, cin: int, cout: int, shortcut: bool = True,
                 quant: str = 'none', k1: int = 1, expansion: float = 0.5):
        super().__init__()
        mid = int(cout * expansion)
        self.cv1 = ConvBlock(cin, mid, k1, quant=quant, store_out=k1 == 1)
        self.cv2 = ConvBlock(mid, cout, 3, quant=quant)
        self.add = shortcut and cin == cout

    def forward(self, x: Union[torch.Tensor, QT]) -> torch.Tensor:
        y = self.cv2(self.cv1(x))
        return as_float(x, y.dtype) + y if self.add else y


class CSPLayer(nn.Module):
    """y1 = bottlenecks(cv1(x)); y2 = cv2(x); out = cv3(cat(y1, y2)).
    store_out: cv3's output may be an int8 edge (the caller's consumer
    takes a QT)."""

    def __init__(self, cin: int, cout: int, n_bottlenecks: int = 1,
                 quant: str = 'none', store_out: bool = False):
        super().__init__()
        c_ = cout // 2
        self.cv1 = ConvBlock(cin, c_, 1, quant=quant)
        self.cv2 = ConvBlock(cin, c_, 1, quant=quant)
        self.cv3 = ConvBlock(2 * c_, cout, 1, quant=quant,
                             store_out=store_out)
        self.bottlenecks = nn.ModuleList(
            DarkBottleneck(c_, c_, True, quant) for _ in range(n_bottlenecks))

    def forward(self, x: Union[torch.Tensor, QT]
                ) -> Union[torch.Tensor, QT]:
        y1 = self.cv1(x)
        for m in self.bottlenecks:
            y1 = m(y1)
        y2 = self.cv2(x)
        return self.cv3(torch.cat([as_float(y1, y2.dtype), y2], dim=1))


class C2fLayer(nn.Module):
    """YOLOv8's C2f block (`CSPLayerWithTwoConv`): a 1x1 `main_conv` to
    2 mid channels (mid = cout / 2), split in two; n bottlenecks (3x3 ->
    3x3 at mid) one after another, each on the last chunk; every chunk
    concatenated, (2 + n + extra) mid channels, then a 1x1 `final_conv`
    to cout. `extra` counts chunks a subclass appends (the neck's
    attention branch)."""

    def __init__(self, cin: int, cout: int, n: int = 1,
                 shortcut: bool = True, quant: str = 'none', extra: int = 0):
        super().__init__()
        self.mid = mid = cout // 2
        self.main_conv = ConvBlock(cin, 2 * mid, 1, quant=quant)
        self.blocks = nn.ModuleList(
            DarkBottleneck(mid, mid, shortcut, quant, k1=3, expansion=1.0)
            for _ in range(n))
        self.final_conv = ConvBlock((2 + n + extra) * mid, cout, 1,
                                    quant=quant)

    def chunks(self, x: torch.Tensor) -> list:
        """[main_conv's two halves, each bottleneck's output]."""
        out = list(self.main_conv(x).split((self.mid, self.mid), dim=1))
        for m in self.blocks:
            out.append(m(out[-1]))
        return out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.final_conv(torch.cat(self.chunks(x), dim=1))


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

    def forward(self, x: Union[torch.Tensor, QT]) -> torch.Tensor:
        x = self.cv1(x)
        p = self.k // 2
        pool = functools.partial(F.max_pool2d, kernel_size=self.k, stride=1,
                                 padding=p)
        y1 = spatial.halo(pool, x, self.k, 1, p)
        y2 = spatial.halo(pool, y1, self.k, 1, p)
        y3 = spatial.halo(pool, y2, self.k, 1, p)
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
            scores = torch.matmul(at_least_fp32(q),
                                  at_least_fp32(k).transpose(2, 3))
        scores = scores / math.sqrt(hd)
        if attn_mask is not None:
            scores = scores + attn_mask.float()
        attn = torch.softmax(scores, dim=-1).to(v.dtype)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(B, Lq, E)
        return self.out_proj(out)
