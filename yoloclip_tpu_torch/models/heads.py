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

YOLO-World v2's head (`YOLOWorldHeadModule` with `use_bn_head=True`, mmyolo's
names under `bbox_head.head_module`):
  * cls_preds: per level Conv3x3 -> Conv3x3 at hidden_dim -> 1x1 to the
    embedding width (a `Proj1x1`, so it folds onto the text);
  * cls_contrasts: `BNContrastiveHead`, logit = BN(embedding) . t_hat x
    exp(logit_scale) + bias, scalars logit_scale and bias a level; scores
    are the logit's sigmoid;
  * reg_preds: per level Conv3x3 -> Conv3x3 at max(16, c3 / 4,
    4 (reg_max + 1)) (mmyolo's YOLOv8HeadModule) -> 1x1 to 4 (reg_max + 1),
    DFL bins 0..reg_max coordinate-major, decoded as ltrb distances
    (x stride) from the anchor centre (`decode_ltrb`).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from yoloclip_tpu_torch.models.layers import (BatchNorm2d, ConvBlock,
                                              at_least_fp32)


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
        o = at_least_fp32(obj.permute(0, 2, 3, 1).reshape(B, -1, E))
        o = o / torch.linalg.vector_norm(o, dim=-1,
                                         keepdim=True).clamp_min(1e-12)
        t = at_least_fp32(text)
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
    p = torch.softmax(at_least_fp32(pred).reshape(B, 4, nbins, H, W),
                      dim=2)
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


class BNContrastiveHead(nn.Module):
    """YOLO-World's BatchNorm contrastive head: logits (B, H*W, C) =
    BN(x) . normalize(text) x exp(logit_scale) + bias, in fp32. Its
    BatchNorm is under `bn` (mmyolo: `norm`)."""

    def __init__(self, embed_dim: int):
        super().__init__()
        self.bn = BatchNorm2d(embed_dim)
        self.bias = nn.Parameter(torch.zeros(()))
        self.logit_scale = nn.Parameter(torch.full((), -1.0))

    def forward(self, x: torch.Tensor, text: torch.Tensor) -> torch.Tensor:
        """x (B, E, H, W), text (B, C, E) -> logits (B, H*W, C)."""
        with torch.autocast(x.device.type, enabled=False):
            x = self.bn(at_least_fp32(x))
            B, E = x.shape[:2]
            o = x.permute(0, 2, 3, 1).reshape(B, -1, E)
            t = at_least_fp32(text)
            t = t / torch.linalg.vector_norm(t, dim=-1,
                                             keepdim=True).clamp_min(1e-12)
            return (torch.matmul(o, t.transpose(1, 2))
                    * self.logit_scale.exp() + self.bias)

    def folded(self, kernel: torch.Tensor, bias: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The projection (kernel (Kd, E), bias (E,)) followed by this
        head's eval-mode BatchNorm as one affine map: (kernel diag(s),
        s bias + t), s = gamma / sqrt(var + eps), t = beta - mean s,
        fp32."""
        bn = self.bn
        s = bn.weight.float() * torch.rsqrt(bn.running_var.float() + bn.eps)
        t = bn.bias.float() - bn.running_mean.float() * s
        return kernel.float() * s[None, :], bias.float() * s + t


class YOLOWorldHeadModule(nn.Module):
    """YOLO-World v2's per-level cls towers, reg towers and BatchNorm
    contrastive heads (the module docstring's `bbox_head.head_module`)."""

    def __init__(self, in_channels: Sequence[int], embed_dim: int = 512,
                 hidden_dim: int = 256, reg_max: int = 15,
                 quant: str = 'none'):
        super().__init__()
        box_hidden = max(16, in_channels[0] // 4, 4 * (reg_max + 1))
        self.cls_preds = nn.ModuleList(
            nn.Sequential(ConvBlock(c, hidden_dim, 3, quant=quant),
                          ConvBlock(hidden_dim, hidden_dim, 3, quant=quant),
                          Proj1x1(hidden_dim, embed_dim))
            for c in in_channels)
        self.reg_preds = nn.ModuleList(
            _tower(c, box_hidden, 4 * (reg_max + 1), quant)
            for c in in_channels)
        self.cls_contrasts = nn.ModuleList(
            BNContrastiveHead(embed_dim) for _ in in_channels)

    def hidden(self, level: int, x: torch.Tensor) -> torch.Tensor:
        """The cls tower's map before its 1x1 projection."""
        tower = self.cls_preds[level]
        return tower[1](tower[0](x))

    def logits(self, level: int, x: torch.Tensor,
               text: torch.Tensor) -> torch.Tensor:
        """(B, H*W, C) fp32 logits of one level, unfolded."""
        return self.cls_contrasts[level](
            self.cls_preds[level][2](self.hidden(level, x)), text)

    def folded(self, level: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """(kernel (Kd, E), bias (E,)) of the level's projection and
        BatchNorm folded together, fp32."""
        return self.cls_contrasts[level].folded(
            *self.cls_preds[level][2].weights())

    def scale_bias(self, level: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """(exp(logit_scale), bias) of the level's contrastive head."""
        head = self.cls_contrasts[level]
        return head.logit_scale.float().exp(), head.bias.float()


def decode_ltrb(box_preds: Sequence[torch.Tensor], strides: Sequence[int],
                reg_max: int = 15) -> torch.Tensor:
    """Per-level raw DFL maps (B, 4 (reg_max + 1), H, W), coordinate-major
    -> xyxy boxes (B, total_anchors, 4) fp32: the expectation over bins
    0..reg_max of each coordinate's softmax is a distance (left, top,
    right, bottom) in strides from the anchor centre ((x + 0.5) stride,
    (y + 0.5) stride), as mmyolo's DistancePointBBoxCoder decodes."""
    out = []
    for pred, stride in zip(box_preds, strides):
        B, _, H, W = pred.shape
        d = dfl_expectation(pred, reg_max).permute(0, 2, 3, 1) * float(stride)
        gy, gx = torch.meshgrid(
            torch.arange(H, dtype=torch.float32, device=pred.device),
            torch.arange(W, dtype=torch.float32, device=pred.device),
            indexing='ij')
        centre = (torch.stack([gx, gy], dim=-1) + 0.5) * float(stride)
        boxes = torch.cat([centre - d[..., :2], centre + d[..., 2:]], dim=-1)
        out.append(boxes.reshape(B, H * W, 4))
    return torch.cat(out, dim=1)
