"""Detection heads and the DFL box decode. Counterpart of
`yoloclip_tpu/models/heads.py`.

  * TextContrastiveHead: obj tower Conv3x3 -> Conv3x3 -> 1x1 projection to
    the embedding width (`obj_embed_conv.{0,1,2}`); its auxiliary DFL box
    tower (`box_conv`) exists only when the weights carry it.
  * compute_similarity: L2-normalised cosine obj . text, alpha*sim + beta.
  * BoxHead: per level Conv3x3 -> Conv3x3 -> 1x1 to 4*(reg_max+1).
  * decode_boxes: per-coordinate softmax over reg_max+1 bins, expectation,
    xy = (grid + reg_xy)*stride, wh = exp(reg_wh)*stride (the reference's
    exp decode), always in fp32.
Anchors are level-major, then y*W + x within a level.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from yoloclip_tpu_torch.models.layers import ConvBlock


class Proj1x1(nn.Conv2d):
    """1x1 conv with bias whose weights are also retrievable as a matrix,
    so the composite can fold the projection into the text side of the
    similarity (`ops/kernels/similarity.py`). Its parameters stay fp32
    (the compute-dtype cast skips them) and are cast at use, so the fold
    reads the fp32 kernel, as in the JAX package."""

    def __init__(self, cin: int, cout: int):
        super().__init__(cin, cout, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight.to(x.dtype), self.bias.to(x.dtype))

    def weights(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(kernel (Cin, Cout), bias (Cout,)) in fp32."""
        return self.weight[:, :, 0, 0].t().float(), self.bias.float()


def _tower(cin: int, hidden: int, cout: int,
           quant: str = 'none') -> nn.Sequential:
    return nn.Sequential(ConvBlock(cin, hidden, 3, quant=quant),
                         ConvBlock(hidden, hidden, 3, quant=quant),
                         nn.Conv2d(hidden, cout, 1))


class TextContrastiveHead(nn.Module):
    def __init__(self, cin: int, embed_dim: int = 512, hidden_dim: int = 256,
                 reg_max: int = 16, cls_alpha: float = 1.0,
                 cls_beta: float = 0.0, with_aux_box: bool = False,
                 quant: str = 'none'):
        super().__init__()
        self.cls_alpha, self.cls_beta = cls_alpha, cls_beta
        self.obj_embed_conv = nn.Sequential(
            ConvBlock(cin, hidden_dim, 3, quant=quant),
            ConvBlock(hidden_dim, hidden_dim, 3, quant=quant),
            Proj1x1(hidden_dim, embed_dim))
        if with_aux_box:   # weights only: the composite never runs it
            self.box_conv = _tower(cin, hidden_dim, 4 * (reg_max + 1), quant)

    def forward(self, x: torch.Tensor, return_hidden: bool = False):
        """x (B, C, H, W) -> obj (B, E, H, W); with return_hidden=True
        (h, kernel, bias) instead: the pre-projection hidden map and the
        projection's weights, for the folded scoring."""
        h = self.obj_embed_conv[1](self.obj_embed_conv[0](x))
        proj = self.obj_embed_conv[2]
        if return_hidden:
            kernel, bias = proj.weights()
            return h, kernel, bias
        return proj(h)

    def compute_similarity(self, obj: torch.Tensor,
                           text: torch.Tensor) -> torch.Tensor:
        return compute_similarity(obj, text, self.cls_alpha, self.cls_beta)


def compute_similarity(obj: torch.Tensor, text: torch.Tensor,
                       cls_alpha: float = 1.0,
                       cls_beta: float = 0.0) -> torch.Tensor:
    """obj (B, E, H, W), text (B, C, E) -> (B, H*W, C) fp32 raw cosine,
    also under a bf16 autocast (the bf16 train step)."""
    B, E = obj.shape[:2]
    with torch.autocast(obj.device.type, enabled=False):
        o = obj.permute(0, 2, 3, 1).reshape(B, -1, E).float()
        o = o / torch.linalg.vector_norm(o, dim=-1,
                                         keepdim=True).clamp_min(1e-12)
        t = text.float()
        t = t / torch.linalg.vector_norm(t, dim=-1,
                                         keepdim=True).clamp_min(1e-12)
        sim = torch.matmul(o, t.transpose(1, 2))
    return cls_alpha * sim + cls_beta


class BoxHead(nn.Module):
    def __init__(self, in_channels: Sequence[int], hidden_dim: int = 256,
                 reg_max: int = 16, quant: str = 'none'):
        super().__init__()
        self.box_convs = nn.ModuleList(
            _tower(c, hidden_dim, 4 * (reg_max + 1), quant)
            for c in in_channels)

    def forward(self, features: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """list of (B, C, H, W) -> list of raw (B, 4*(reg_max+1), H, W)."""
        return [tower(f) for tower, f in zip(self.box_convs, features)]


def dfl_expectation(pred: torch.Tensor, reg_max: int) -> torch.Tensor:
    """Raw (B, 4*(reg_max+1), H, W) -> expected offsets (B, 4, H, W) in
    fp32: softmax over each coordinate's bins, expectation over 0..reg_max.
    Channel 17*coord + bin, as in the JAX NHWC layout."""
    B, C, H, W = pred.shape
    nbins = reg_max + 1
    p = torch.softmax(pred.float().reshape(B, 4, nbins, H, W), dim=2)
    bins = torch.arange(nbins, dtype=torch.float32, device=pred.device)
    return (p * bins[:, None, None]).sum(dim=2)


def decode_boxes(box_preds: Sequence[torch.Tensor], strides: Sequence[int],
                 reg_max: int = 16) -> torch.Tensor:
    """Per-level raw DFL maps -> xyxy boxes (B, total_anchors, 4) fp32."""
    out = []
    for pred, stride in zip(box_preds, strides):
        B, _, H, W = pred.shape
        reg = dfl_expectation(pred, reg_max).permute(0, 2, 3, 1)   # B,H,W,4
        gy, gx = torch.meshgrid(
            torch.arange(H, dtype=torch.float32, device=pred.device),
            torch.arange(W, dtype=torch.float32, device=pred.device),
            indexing='ij')
        grid = torch.stack([gx, gy], dim=-1)                       # H,W,2
        xy = (grid + reg[..., :2]) * float(stride)
        wh = torch.exp(reg[..., 2:]) * float(stride)
        boxes = torch.cat([xy - wh / 2, xy + wh / 2], dim=-1)
        out.append(boxes.reshape(B, H * W, 4))
    return torch.cat(out, dim=1)


def flatten_levels(maps: Sequence[torch.Tensor]) -> torch.Tensor:
    """list of (B, C, H, W) -> (B, sum H*W, C), level-major, y*W + x."""
    return torch.cat([m.permute(0, 2, 3, 1).reshape(m.shape[0], -1,
                                                    m.shape[1])
                      for m in maps], dim=1)

