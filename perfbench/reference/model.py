"""Plain float32 YOLO-CLIP forward: the benchmark's own reference.

A frozen copy of the detector's mathematics written in plain PyTorch ops,
with no kernel, no program, no cache and no reduced precision. It imports
nothing of the system under test. Module and parameter names follow the
reference torch key layout (`backbone.stem.conv.weight`, ...), so the one
seeded state dict that the benchmark makes loads into it and into the
system alike.

  * backbone: YOLOv8 CSPDarknet (stem, four stride-2 stages with CSP
    layers, SPPF), widths and depths from the variant's multipliers;
  * neck: RepVL-PAN. Image-pooling attention (3x3 adaptive max pool a
    level, 27 tokens, 8-head attention with the text as query, residual),
    the FPN top-down path (nearest x2, add), 3x3 FPN convs, then bottom-up
    text-guided CSP layers with a max-sigmoid text gate after every
    bottleneck;
  * heads: per level an object tower (3x3, 3x3, 1x1 to the embedding
    width) scored by L2-normalised cosine against the per-image text, and
    a box tower (3x3, 3x3, 1x1 to 4 x (reg_max + 1)) decoded by DFL:
    softmax over the bins, expectation, xy = (grid + reg_xy) x stride,
    wh = exp(reg_wh) x stride.

The reference keeps the whole (B, A, C) similarity, where the system folds
the projection into the text side and never forms it.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

VARIANTS = {'n': (0.25, 0.33), 's': (0.50, 0.33), 'm': (0.75, 0.67),
            'l': (1.00, 1.00), 'x': (1.25, 1.33)}


def channels(variant: str) -> List[int]:
    w = VARIANTS[variant][0]
    return [max(int(c * w), 16) for c in (64, 128, 256, 512, 1024)]


def depths(variant: str) -> List[int]:
    d = VARIANTS[variant][1]
    return [max(int(n * d), 1) for n in (1, 2, 4, 8)]


class ConvBlock(nn.Module):
    """conv (no bias, padding k // 2) -> BatchNorm (eval, eps 1e-5) ->
    SiLU."""

    def __init__(self, cin: int, cout: int, k: int = 3, s: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, s, k // 2, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-5)

    def forward(self, x):
        return F.silu(self.bn(self.conv(x)))


class Bottleneck(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.cv1 = ConvBlock(c, c // 2, 1)
        self.cv2 = ConvBlock(c // 2, c, 3)

    def forward(self, x):
        return x + self.cv2(self.cv1(x))


class CSP(nn.Module):
    def __init__(self, cin: int, cout: int, n: int):
        super().__init__()
        c = cout // 2
        self.cv1 = ConvBlock(cin, c, 1)
        self.cv2 = ConvBlock(cin, c, 1)
        self.cv3 = ConvBlock(2 * c, cout, 1)
        self.bottlenecks = nn.ModuleList(Bottleneck(c) for _ in range(n))

    def forward(self, x):
        y = self.cv1(x)
        for m in self.bottlenecks:
            y = m(y)
        return self.cv3(torch.cat([y, self.cv2(x)], 1))


class SPPF(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.cv1 = ConvBlock(cin, cin // 2, 1)
        self.cv2 = ConvBlock(2 * cin, cout, 1)

    def forward(self, x):
        x = self.cv1(x)
        ys = [x]
        for _ in range(3):
            ys.append(F.max_pool2d(ys[-1], 5, 1, 2))
        return self.cv2(torch.cat(ys, 1))


class Backbone(nn.Module):
    def __init__(self, variant: str):
        super().__init__()
        ch, dp = channels(variant), depths(variant)
        self.stem = ConvBlock(3, ch[0], 3, 2)
        for s in range(1, 5):
            layers = [ConvBlock(ch[s - 1], ch[s], 3, 2),
                      CSP(ch[s], ch[s], dp[s - 1])]
            if s == 4:
                layers.append(SPPF(ch[4], ch[4]))
            setattr(self, f'stage{s}', nn.Sequential(*layers))

    def forward(self, x):
        x = self.stage1(self.stem(x))
        c3 = self.stage2(x)
        c4 = self.stage3(c3)
        return c3, c4, self.stage4(c4)


class Attention(nn.Module):
    """nn.MultiheadAttention's parameter layout (packed q, k, v), batch
    first, written out."""

    def __init__(self, e: int, heads: int = 8):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * e, e))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * e))
        self.out_proj = nn.Linear(e, e)

    def forward(self, q, kv):
        B, Lq, E = q.shape
        H, hd = self.heads, E // self.heads
        wq, wk, wv = self.in_proj_weight.chunk(3)
        bq, bk, bv = self.in_proj_bias.chunk(3)

        def split(x, w, b):
            return F.linear(x, w, b).reshape(B, -1, H, hd).transpose(1, 2)

        qh, kh, vh = split(q, wq, bq), split(kv, wk, bk), split(kv, wv, bv)
        att = torch.softmax(qh @ kh.transpose(2, 3) / math.sqrt(hd), -1)
        return self.out_proj((att @ vh).transpose(1, 2).reshape(B, Lq, E))


class ImagePooling(nn.Module):
    def __init__(self, cin: Sequence[int], e: int):
        super().__init__()
        self.projections = nn.ModuleList(nn.Linear(c, e) for c in cin)
        self.mha = Attention(e)

    def forward(self, text, feats):
        tokens = []
        for proj, f in zip(self.projections, feats):
            p = F.adaptive_max_pool2d(f, 3)                  # (B, C, 3, 3)
            tokens.append(proj(p.flatten(2).transpose(1, 2)))  # (B, 9, E)
        return text + self.mha(text, torch.cat(tokens, 1))


class TextCSP(nn.Module):
    def __init__(self, c: int, n: int, e: int):
        super().__init__()
        h = c // 2
        self.cv1 = ConvBlock(c, h, 1)
        self.cv2 = ConvBlock(c, h, 1)
        self.cv3 = ConvBlock(2 * h, c, 1)
        self.bottlenecks = nn.ModuleList(Bottleneck(h) for _ in range(n))
        self.text_proj = nn.Linear(e, h)

    def forward(self, x, text):
        y = self.cv1(x)
        t = self.text_proj(text)                              # (B, N, h)
        for m in self.bottlenecks:
            y = m(y)
            s = torch.einsum('bchw,bnc->bnhw', y, t)
            y = y * torch.sigmoid(s.amax(1, keepdim=True))
        return self.cv3(torch.cat([y, self.cv2(x)], 1))


class Neck(nn.Module):
    def __init__(self, c: Sequence[int], e: int, n: int):
        super().__init__()
        self.image_pooling_attention = ImagePooling(c, e)
        self.lateral_convs = nn.ModuleList(ConvBlock(x, x, 1) for x in c)
        self.up_channels = nn.ModuleList([ConvBlock(c[2], c[1], 1),
                                          ConvBlock(c[1], c[0], 1)])
        self.fpn_convs = nn.ModuleList(ConvBlock(x, x, 3) for x in c)
        self.text_csplayers = nn.ModuleList(TextCSP(x, n, e) for x in c)
        self.downsample_convs = nn.ModuleList([ConvBlock(c[0], c[1], 3, 2),
                                               ConvBlock(c[1], c[2], 3, 2)])

    def forward(self, feats, text):
        text = self.image_pooling_attention(text, feats)
        lat = [m(f) for m, f in zip(self.lateral_convs, feats)]

        def up(x):
            return F.interpolate(x, scale_factor=2, mode='nearest')

        p5 = lat[2]
        p4 = lat[1] + self.up_channels[0](up(p5))
        p3 = lat[0] + self.up_channels[1](up(p4))
        f3, f4, f5 = (m(p) for m, p in zip(self.fpn_convs, (p3, p4, p5)))
        n3 = self.text_csplayers[0](f3, text)
        n4 = self.text_csplayers[1](f4 + self.downsample_convs[0](n3), text)
        n5 = self.text_csplayers[2](f5 + self.downsample_convs[1](n4), text)
        return [n3, n4, n5], text


def tower(cin: int, hidden: int, cout: int) -> nn.Sequential:
    return nn.Sequential(ConvBlock(cin, hidden, 3),
                         ConvBlock(hidden, hidden, 3),
                         nn.Conv2d(hidden, cout, 1))


class ObjHead(nn.Module):
    def __init__(self, cin: int, e: int, hidden: int):
        super().__init__()
        self.obj_embed_conv = tower(cin, hidden, e)

    def forward(self, x):
        return self.obj_embed_conv(x)


class BoxHead(nn.Module):
    def __init__(self, cin: Sequence[int], hidden: int, reg_max: int):
        super().__init__()
        self.box_convs = nn.ModuleList(tower(c, hidden, 4 * (reg_max + 1))
                                       for c in cin)


def decode(pred: torch.Tensor, stride: int, reg_max: int) -> torch.Tensor:
    """One level's raw (B, 4 (reg_max + 1), H, W) map -> xyxy (B, H W, 4);
    channel 17 coord + bin."""
    B, _, H, W = pred.shape
    p = torch.softmax(pred.reshape(B, 4, reg_max + 1, H, W), 2)
    bins = torch.arange(reg_max + 1, dtype=p.dtype, device=p.device)
    reg = (p * bins[:, None, None]).sum(2).permute(0, 2, 3, 1)   # B,H,W,4
    gy, gx = torch.meshgrid(torch.arange(H, dtype=p.dtype, device=p.device),
                            torch.arange(W, dtype=p.dtype, device=p.device),
                            indexing='ij')
    xy = (torch.stack([gx, gy], -1) + reg[..., :2]) * stride
    wh = torch.exp(reg[..., 2:]) * stride
    return torch.cat([xy - wh / 2, xy + wh / 2], -1).reshape(B, H * W, 4)


class YOLOCLIPReference(nn.Module):
    """The detector's forward in float32. `forward(canvas, text)`: canvases
    (B, 3, H, W) in [0, 1], text (C, E) -> boxes (B, A, 4) in canvas pixels
    and the cosine similarity (B, A, C)."""

    def __init__(self, variant: str, embed_dim: int = 512, hidden: int = 256,
                 reg_max: int = 16, neck_bottlenecks: int = 2,
                 strides: Sequence[int] = (8, 16, 32)):
        super().__init__()
        fc = channels(variant)[2:]
        self.reg_max, self.strides = reg_max, tuple(strides)
        self.backbone = Backbone(variant)
        self.neck = Neck(fc, embed_dim, neck_bottlenecks)
        self.contrastive_heads = nn.ModuleList(ObjHead(c, embed_dim, hidden)
                                               for c in fc)
        self.box_head = BoxHead(fc, hidden, reg_max)

    def forward(self, canvas: torch.Tensor, text: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        B = canvas.shape[0]
        feats = self.backbone(canvas)
        pan, text = self.neck(feats, text[None].expand(B, -1, -1))
        t = F.normalize(text, dim=-1, eps=1e-12)
        sims, boxes = [], []
        for head, box, f, s in zip(self.contrastive_heads,
                                   self.box_head.box_convs, pan,
                                   self.strides):
            o = head(f).flatten(2).transpose(1, 2)            # (B, HW, E)
            sims.append(F.normalize(o, dim=-1, eps=1e-12) @ t.transpose(1, 2))
            boxes.append(decode(box(f), s, self.reg_max))
        return torch.cat(boxes, 1), torch.cat(sims, 1)


def fp32_strict():
    """A context in which float32 matmuls and convs run in float32 (TF32
    off), restoring the previous settings on exit."""
    class _Strict:
        def __enter__(self):
            self.saved = (torch.backends.cuda.matmul.allow_tf32,
                          torch.backends.cudnn.allow_tf32)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False

        def __exit__(self, *exc):
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = self.saved
            return False
    return _Strict()


def state_shapes(variant: str) -> Dict[str, Tuple[int, ...]]:
    """Every state-dict key of the reference layout and its shape."""
    with torch.device('meta'):
        m = YOLOCLIPReference(variant)
    return {k: tuple(v.shape) for k, v in m.state_dict().items()}
