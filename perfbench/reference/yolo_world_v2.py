"""Plain float32 YOLO-World v2 forward: the benchmark's reference of the
`yolo_world_v2` architecture (Cheng et al., arXiv:2401.17270; mmyolo's
`YOLOWorldDetector` with `YOLOv8CSPDarknet`, `YOLOWorldPAFPN` over
`MaxSigmoidCSPLayerWithTwoConv` and `YOLOWorldHeadModule(use_bn_head=True)`,
as github.com/AILab-CVC/YOLO-World's
`configs/pretrain/yolo_world_v2_l_vlpan_bn_*` builds it). Plain PyTorch
ops, no kernel, no program, no reduced precision; the caller turns TF32
off (`reference/model.py::fp32_strict`). It imports nothing of the system
under test.

  * backbone: stem 3x3/2, four stages of a 3x3/2 conv and a C2f block
    (`CSPLayerWithTwoConv`: 1x1 main conv to 2 mid, split, n bottlenecks
    3x3 -> 3x3 at mid with the identity added, each on the last chunk,
    every chunk concatenated, 1x1 final conv), SPPF (k5) closing stage 4;
  * neck: top-down (nearest x2 of the upper level, concatenated before
    the lower), bottom-up (3x3/2 conv of the lower, concatenated before the
    upper level), each step a C2f block without identity whose last chunk
    also goes through the max-sigmoid attention block, appended before the
    final conv: guide = guide_fc(text) (B, N, heads, 32), w[b, m, h, w] =
    sigmoid(max_n sum_c x[b, m, c, h, w] guide[b, n, m, c] / sqrt(32) +
    bias[m]), out = project_conv(x) (3x3 + BatchNorm, no SiLU) with head
    m's channels times w[b, m]; the whole (B, heads, H, W, N) score tensor
    is formed; the block runs at half the level's width in heads of 32
    channels (mmyolo's embed_channels [128, 256, last / 2] and num_heads
    [4, 8, last / 64] at the width multiple);
  * head per level: cls tower 3x3 -> 3x3 -> 1x1 to the embedding width,
    logits BN(embed) . normalize(text) x exp(logit_scale) + bias over every
    class (B, A, C), scores their sigmoid; reg tower 3x3 -> 3x3 at
    max(16, c3 / 4, 4 (reg_max + 1)) -> 1x1 to 4 (reg_max + 1), per coordinate a softmax over bins 0..reg_max and its
    expectation, ltrb distances x stride from the anchor centre
    ((x + 0.5) stride, (y + 0.5) stride).

Departures from the mmyolo code:
  * BatchNorm eps 1e-5 everywhere (mmyolo: 1e-3), as the system's blocks;
    the benchmark calibrates every running variance, so eps is a rounding
    term either way;
  * no `embed_conv` in the attention block: mmyolo builds one only where
    the embedding width differs from the block's input, and at every
    published variant (n, s, m, l, x) they are equal;
  * `reg_max` is the largest DFL bin here (15: bins 0..15), where mmyolo's
    `reg_max=16` counts the bins;
  * the text is an input (C, E) shared by the batch, the text model's
    normalised output, not encoded here;
  * scores are the whole (B, A, C) sigmoid; the system takes each anchor's
    best class (class-agnostic single-label NMS), where mmyolo's test
    config keeps several labels an anchor.

Module names follow mmyolo's tree (`backbone.image_model.stage1.1.
main_conv.conv.weight`, `neck.top_down_layers.0.attn_block.guide_fc.
weight`, `bbox_head.head_module.cls_preds.0.2.weight`, ...) with these
renames, which the system's blocks force or the BatchNorm calibration
needs (`lib/weights.py::calibrate_batchnorm` finds BatchNorms under
`.bn.`):
  * a C2f bottleneck's `conv1` / `conv2` -> `cv1` / `cv2`;
  * SPPF's `conv1` / `conv2` -> `cv1` / `cv2`;
  * `cls_contrasts.<i>.norm` -> `cls_contrasts.<i>.bn`.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn


class ConvModule(nn.Module):
    """conv (no bias, padding k // 2) -> BatchNorm (eval, eps 1e-5) ->
    SiLU, or no activation with act=False."""

    def __init__(self, cin: int, cout: int, k: int = 1, s: int = 1,
                 act: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, s, k // 2, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-5)
        self.act = act

    def forward(self, x):
        y = self.bn(self.conv(x))
        return F.silu(y) if self.act else y


class Bottleneck(nn.Module):
    def __init__(self, c: int, identity: bool):
        super().__init__()
        self.cv1 = ConvModule(c, c, 3)
        self.cv2 = ConvModule(c, c, 3)
        self.identity = identity

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.identity else y


class C2f(nn.Module):
    """`CSPLayerWithTwoConv`; `extra` chunks appended by a subclass."""

    def __init__(self, cin: int, cout: int, n: int, identity: bool,
                 extra: int = 0):
        super().__init__()
        self.mid = cout // 2
        self.main_conv = ConvModule(cin, 2 * self.mid)
        self.blocks = nn.ModuleList(Bottleneck(self.mid, identity)
                                    for _ in range(n))
        self.final_conv = ConvModule((2 + n + extra) * self.mid, cout)

    def chunks(self, x):
        out = list(self.main_conv(x).split((self.mid, self.mid), 1))
        for m in self.blocks:
            out.append(m(out[-1]))
        return out

    def forward(self, x):
        return self.final_conv(torch.cat(self.chunks(x), 1))


class SPPF(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.cv1 = ConvModule(cin, cin // 2)
        self.cv2 = ConvModule(2 * cin, cout)

    def forward(self, x):
        ys = [self.cv1(x)]
        for _ in range(3):
            ys.append(F.max_pool2d(ys[-1], 5, 1, 2))
        return self.cv2(torch.cat(ys, 1))


class Backbone(nn.Module):
    def __init__(self, ch: Sequence[int], depths: Sequence[int]):
        super().__init__()
        self.stem = ConvModule(3, ch[0], 3, 2)
        for s in range(1, 5):
            layers = [ConvModule(ch[s - 1], ch[s], 3, 2),
                      C2f(ch[s], ch[s], depths[s - 1], True)]
            if s == 4:
                layers.append(SPPF(ch[4], ch[4]))
            setattr(self, f'stage{s}', nn.Sequential(*layers))

    def forward(self, x):
        x = self.stage1(self.stem(x))
        c3 = self.stage2(x)
        c4 = self.stage3(c3)
        return c3, c4, self.stage4(c4)


class MaxSigmoidAttnBlock(nn.Module):
    def __init__(self, c: int, guide: int):
        super().__init__()
        self.heads, self.hc = c // 32, 32
        self.guide_fc = nn.Linear(guide, c)
        self.bias = nn.Parameter(torch.zeros(self.heads))
        self.project_conv = ConvModule(c, c, 3, act=False)

    def forward(self, x, text):
        B, _, H, W = x.shape
        guide = self.guide_fc(text).reshape(B, -1, self.heads, self.hc)
        embed = x.reshape(B, self.heads, self.hc, H, W)
        w = torch.einsum('bmchw,bnmc->bmhwn', embed, guide)
        w = w.max(dim=-1).values / math.sqrt(self.hc)
        w = torch.sigmoid(w + self.bias[None, :, None, None])
        y = self.project_conv(x).reshape(B, self.heads, -1, H, W)
        return (y * w.unsqueeze(2)).reshape(B, -1, H, W)


class MaxSigmoidC2f(C2f):
    def __init__(self, cin: int, cout: int, n: int, guide: int):
        super().__init__(cin, cout, n, False, extra=1)
        self.attn_block = MaxSigmoidAttnBlock(self.mid, guide)

    def forward(self, x, text):
        out = self.chunks(x)
        out.append(self.attn_block(out[-1], text))
        return self.final_conv(torch.cat(out, 1))


class Neck(nn.Module):
    def __init__(self, c: Sequence[int], guide: int, n: int):
        super().__init__()

        def layer(cin, lvl):
            return MaxSigmoidC2f(cin, c[lvl], n, guide)
        self.top_down_layers = nn.ModuleList([layer(c[1] + c[2], 1),
                                              layer(c[0] + c[1], 0)])
        self.downsample_layers = nn.ModuleList(
            ConvModule(c[i], c[i], 3, 2) for i in range(2))
        self.bottom_up_layers = nn.ModuleList([layer(c[0] + c[1], 1),
                                               layer(c[1] + c[2], 2)])

    def forward(self, feats, text):
        c3, c4, c5 = feats

        def up(x):
            return F.interpolate(x, scale_factor=2, mode='nearest')

        p4 = self.top_down_layers[0](torch.cat([up(c5), c4], 1), text)
        n3 = self.top_down_layers[1](torch.cat([up(p4), c3], 1), text)
        n4 = self.bottom_up_layers[0](
            torch.cat([self.downsample_layers[0](n3), p4], 1), text)
        n5 = self.bottom_up_layers[1](
            torch.cat([self.downsample_layers[1](n4), c5], 1), text)
        return n3, n4, n5


def tower(cin: int, hidden: int, cout: int) -> nn.Sequential:
    return nn.Sequential(ConvModule(cin, hidden, 3),
                         ConvModule(hidden, hidden, 3),
                         nn.Conv2d(hidden, cout, 1))


class BNContrastiveHead(nn.Module):
    def __init__(self, e: int):
        super().__init__()
        self.bn = nn.BatchNorm2d(e, eps=1e-5)
        self.bias = nn.Parameter(torch.zeros(()))
        self.logit_scale = nn.Parameter(torch.full((), -1.0))

    def forward(self, x, text):
        """x (B, E, H, W), text (B, C, E) -> logits (B, H W, C)."""
        x = self.bn(x).flatten(2).transpose(1, 2)
        w = F.normalize(text, dim=-1, p=2)
        return (x @ w.transpose(1, 2)) * self.logit_scale.exp() + self.bias


class HeadModule(nn.Module):
    def __init__(self, cin: Sequence[int], e: int, hidden: int,
                 reg_max: int):
        super().__init__()
        box_hidden = max(16, cin[0] // 4, 4 * (reg_max + 1))
        self.cls_preds = nn.ModuleList(tower(c, hidden, e) for c in cin)
        self.reg_preds = nn.ModuleList(
            tower(c, box_hidden, 4 * (reg_max + 1)) for c in cin)
        self.cls_contrasts = nn.ModuleList(BNContrastiveHead(e)
                                           for _ in cin)


def decode(pred: torch.Tensor, stride: int, reg_max: int) -> torch.Tensor:
    """One level's raw (B, 4 (reg_max + 1), H, W) map, coordinate-major ->
    xyxy (B, H W, 4)."""
    B, _, H, W = pred.shape
    p = torch.softmax(pred.reshape(B, 4, reg_max + 1, H, W), 2)
    bins = torch.arange(reg_max + 1, dtype=p.dtype, device=p.device)
    d = (p * bins[:, None, None]).sum(2).permute(0, 2, 3, 1) * stride
    gy, gx = torch.meshgrid(torch.arange(H, dtype=p.dtype, device=p.device),
                            torch.arange(W, dtype=p.dtype, device=p.device),
                            indexing='ij')
    c = (torch.stack([gx, gy], -1) + 0.5) * stride
    return torch.cat([c - d[..., :2], c + d[..., 2:]], -1).reshape(
        B, H * W, 4)


class YOLOWorldV2Reference(nn.Module):
    """`forward(canvas, text)`: canvases (B, 3, H, W) in [0, 1], text
    (C, E) -> boxes (B, A, 4) in canvas pixels and sigmoid scores
    (B, A, C). channels: the five backbone widths (stem, stages 1-4);
    depths: the four stages' bottleneck counts."""

    def __init__(self, channels: Sequence[int], depths: Sequence[int],
                 embed_dim: int = 512, hidden: int = 256,
                 reg_max: int = 15, neck_blocks: int = 3,
                 strides: Sequence[int] = (8, 16, 32)):
        super().__init__()
        fc = list(channels[2:])
        self.reg_max, self.strides = reg_max, tuple(strides)
        self.backbone = nn.ModuleDict({'image_model': Backbone(channels,
                                                               depths)})
        self.neck = Neck(fc, embed_dim, neck_blocks)
        self.bbox_head = nn.ModuleDict({'head_module': HeadModule(
            fc, embed_dim, hidden, reg_max)})

    def forward(self, canvas: torch.Tensor, text: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        B = canvas.shape[0]
        text = text[None].expand(B, -1, -1)
        pan = self.neck(self.backbone['image_model'](canvas), text)
        head = self.bbox_head['head_module']
        logits: List[torch.Tensor] = []
        boxes: List[torch.Tensor] = []
        for i, (f, s) in enumerate(zip(pan, self.strides)):
            logits.append(head.cls_contrasts[i](head.cls_preds[i](f), text))
            boxes.append(decode(head.reg_preds[i](f), s, self.reg_max))
        return torch.cat(boxes, 1), torch.sigmoid(torch.cat(logits, 1))
