"""Shared building blocks. Counterpart of `yoloclip_tpu/models/layers.py`
(float path only: no int8 `quant`, no int8-stored `QT` edges, no
space-to-depth stems).

Tensors are NCHW in channels_last memory format. Module and parameter names
follow the reference torch layout that `utils/convert.py::build_key_map`
spells out, so converted weights load with strict=True.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


class ConvBlock(nn.Module):
    """Conv (no bias, padding k//2) + BatchNorm (eps 1e-5) + SiLU."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 3,
                 stride: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel_size, stride,
                              kernel_size // 2, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.silu(self.bn(self.conv(x)))


class DarkBottleneck(nn.Module):
    """1x1 squeeze to c/2 -> 3x3 expand to c; residual when the input
    already has c channels and shortcut=True."""

    def __init__(self, cin: int, cout: int, shortcut: bool = True):
        super().__init__()
        self.cv1 = ConvBlock(cin, cout // 2, 1)
        self.cv2 = ConvBlock(cout // 2, cout, 3)
        self.add = shortcut and cin == cout

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class CSPLayer(nn.Module):
    """y1 = bottlenecks(cv1(x)); y2 = cv2(x); out = cv3(cat(y1, y2))."""

    def __init__(self, cin: int, cout: int, n_bottlenecks: int = 1):
        super().__init__()
        c_ = cout // 2
        self.cv1 = ConvBlock(cin, c_, 1)
        self.cv2 = ConvBlock(cin, c_, 1)
        self.cv3 = ConvBlock(2 * c_, cout, 1)
        self.bottlenecks = nn.ModuleList(
            DarkBottleneck(c_, c_, True) for _ in range(n_bottlenecks))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y1 = self.cv1(x)
        for m in self.bottlenecks:
            y1 = m(y1)
        return self.cv3(torch.cat([y1, self.cv2(x)], dim=1))


class SPPF(nn.Module):
    """cv1 to cin//2, three chained k x k max pools (stride 1, -inf
    padding), cat(x, y1, y2, y3), cv2."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 5):
        super().__init__()
        c_ = cin // 2
        self.cv1 = ConvBlock(cin, c_, 1)
        self.cv2 = ConvBlock(4 * c_, cout, 1)
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
    The scores and the softmax are fp32 whatever the compute dtype."""

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
        scores = torch.matmul(q, k.transpose(2, 3)).float() / math.sqrt(hd)
        if attn_mask is not None:
            scores = scores + attn_mask.float()
        attn = torch.softmax(scores, dim=-1).to(v.dtype)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(B, Lq, E)
        return self.out_proj(out)
