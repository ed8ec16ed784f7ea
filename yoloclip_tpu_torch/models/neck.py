"""RepVL-PAN neck. Counterpart of `yoloclip_tpu/models/neck.py`.

  * Image-pooling attention first: a 3x3 adaptive max pool per level gives
    27 patch tokens, projected to the text width; 8-head attention with the
    text as query; residual add. From here on the text is per image.
  * FPN top-down: channel-keeping 1x1 laterals, nearest x2 upsample, 1x1
    channel adjust, ADD.
  * 3x3 FPN convs, then bottom-up PAN with stride-2 downsampling and a
    text-guided CSP layer at each level, with max-sigmoid text attention
    after every bottleneck.

Over a class shard (`class_shard`, the 'model' axis) the text is the
shard's block of classes: the max-sigmoid max over classes goes through
`collectives.class_max`; I-Pool needs no collective (its queries are the
classes, each attending on its own). Under a height partition
(`parallel/spatial.py`) I-Pool's pooled tokens are the whole frame's.

YOLO-World v2's neck (`YOLOWorldPAFPN`, mmyolo's module tree): no
image-pooling attention and no text update. Top-down, the upper level is
upsampled (nearest x2) and concatenated before the lower one; bottom-up, a
stride-2 3x3 conv of the lower output is concatenated before the upper
level; each step runs a `MaxSigmoidCSPLayer`, a C2f block whose last chunk
also goes through a `MaxSigmoidAttnBlock`, appended before `final_conv`.
The attention's widths follow from the level's: half of it, in heads of
HEAD_CHANNELS (mmyolo's [128, 256, last / 2] and [4, 8, last / 64] at the
width multiple, which come to the same at every published variant).
The block's per-head max over the classes is taken on the whole (B, heads,
H, W, N) score tensor, in plain torch ops. Each attention block is a graph
stage of its own: a mark before it (`neck_convs.<layer>`) and after it
(`text_attn.<layer>`, `utils/profiling.py::mark`). Neither the class
shard nor the height partition is implemented for it.
"""

from __future__ import annotations

import functools
import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from yoloclip_tpu_torch.models.layers import (C2fLayer, ConvBlock,
                                              DarkBottleneck,
                                              MultiHeadAttention,
                                              at_least_fp32)
from yoloclip_tpu_torch.parallel import spatial
from yoloclip_tpu_torch.parallel.collectives import ClassShard, class_max
from yoloclip_tpu_torch.utils import profiling

HEAD_CHANNELS = 32    # YOLO-World's max-sigmoid attention: channels a head


class TextGuidedCSPLayer(nn.Module):
    def __init__(self, cin: int, cout: int, n_bottlenecks: int,
                 text_dim: int, quant: str = 'none'):
        super().__init__()
        c_ = cout // 2
        self.cv1 = ConvBlock(cin, c_, 1, quant=quant)
        self.cv2 = ConvBlock(cin, c_, 1, quant=quant)
        self.cv3 = ConvBlock(2 * c_, cout, 1, quant=quant)
        self.bottlenecks = nn.ModuleList(
            DarkBottleneck(c_, c_, True, quant) for _ in range(n_bottlenecks))
        self.text_proj = nn.Linear(text_dim, c_)

    def forward(self, x: torch.Tensor, text: torch.Tensor,
                class_mask: Optional[torch.Tensor] = None,
                class_shard: Optional[ClassShard] = None) -> torch.Tensor:
        """x (B, Cin, H, W); text (B, N, text_dim); class_mask (B, N) bool
        or None: masked-out classes get -inf before the max. class_shard:
        text and mask are this shard's block of classes."""
        group = class_shard.group if class_shard is not None else None
        y1 = self.cv1(x)
        proj = self.text_proj(text.to(self.text_proj.weight.dtype))
        for m in self.bottlenecks:
            y1 = m(y1)
            # max over classes of feat . projected text, then a sigmoid gate
            # fp32 scores from the compute-dtype operands, as JAX's
            # preferred_element_type=float32 einsum
            with torch.autocast(y1.device.type, enabled=False):
                scores = torch.einsum('bchw,bnc->bnhw', at_least_fp32(y1),
                                      at_least_fp32(proj))
            if class_mask is not None:
                scores = scores.masked_fill(~class_mask[:, :, None, None],
                                            float('-inf'))
            gate = torch.sigmoid(class_max(scores, 1, group))
            y1 = y1 * gate.to(y1.dtype)
        return self.cv3(torch.cat([y1, self.cv2(x)], dim=1))


class ImagePoolingAttention(nn.Module):
    def __init__(self, in_channels: Sequence[int], embed_dim: int,
                 num_heads: int = 8):
        super().__init__()
        self.projections = nn.ModuleList(
            nn.Linear(c, embed_dim) for c in in_channels)
        self.mha = MultiHeadAttention(embed_dim, num_heads)

    def forward(self, text: torch.Tensor,
                feature_maps: Sequence[torch.Tensor]) -> torch.Tensor:
        tokens = []
        for proj, fm in zip(self.projections, feature_maps):
            # AdaptiveMaxPool2d windows, as JAX's adaptive_max_pool_2d
            pooled = spatial.adaptive_max_pool3(fm)         # (B, C, 3, 3)
            B, C = pooled.shape[:2]
            # row-major (y, x) token order, as the NHWC reshape in JAX
            patch = pooled.permute(0, 2, 3, 1).reshape(B, 9, C)
            tokens.append(proj(patch))
        all_tokens = torch.cat(tokens, dim=1)               # (B, 27, E)
        # the residual stays in the text's dtype (fp32), as in JAX
        update = self.mha(text.to(all_tokens.dtype), all_tokens, all_tokens)
        return text + update.to(text.dtype)


class RepVLPAN(nn.Module):
    def __init__(self, in_channels: Sequence[int],
                 out_channels: Sequence[int], text_dim: int = 512,
                 n_bottlenecks: int = 1, quant: str = 'none'):
        super().__init__()
        ic, oc, q = in_channels, out_channels, quant
        self.image_pooling_attention = ImagePoolingAttention(ic, text_dim)
        self.lateral_convs = nn.ModuleList(
            ConvBlock(ic[i], ic[i], 1, quant=q) for i in range(3))
        self.up_channels = nn.ModuleList(
            [ConvBlock(ic[2], ic[1], 1, quant=q),
             ConvBlock(ic[1], ic[0], 1, quant=q)])
        self.fpn_convs = nn.ModuleList(
            ConvBlock(ic[i], oc[i], 3, quant=q) for i in range(3))
        self.text_csplayers = nn.ModuleList(
            TextGuidedCSPLayer(oc[i], oc[i], n_bottlenecks, text_dim, q)
            for i in range(3))
        self.downsample_convs = nn.ModuleList(
            [ConvBlock(oc[0], oc[1], 3, 2, quant=q),
             ConvBlock(oc[1], oc[2], 3, 2, quant=q)])

    def forward(self, features: Sequence[torch.Tensor], text: torch.Tensor,
                class_mask: Optional[torch.Tensor] = None,
                skip_image_pool: bool = False,
                class_shard: Optional[ClassShard] = None
                ) -> Tuple[List[torch.Tensor], torch.Tensor]:
        """features (c3, c4, c5); text (B, N, text_dim); class_mask (B, N)
        bool or None -> ([n3, n4, n5], per-image text after I-Pool).

        skip_image_pool=True leaves the text as it came (the reparam deploy
        opt-in, `ops/reparam.py`); I-Pool is not computed at all, where the
        JAX package computes it and leaves its output unused."""
        if not skip_image_pool:
            text = self.image_pooling_attention(text, features)

        lat = [conv(f) for conv, f in zip(self.lateral_convs, features)]
        p5 = lat[2]
        up = functools.partial(F.interpolate, scale_factor=2, mode='nearest')
        p4 = lat[1] + self.up_channels[0](up(p5))
        p3 = lat[0] + self.up_channels[1](up(p4))
        fpn = [conv(p) for conv, p in zip(self.fpn_convs, (p3, p4, p5))]

        kw = dict(class_mask=class_mask, class_shard=class_shard)
        n3 = self.text_csplayers[0](fpn[0], text, **kw)
        n4 = self.text_csplayers[1](fpn[1] + self.downsample_convs[0](n3),
                                    text, **kw)
        n5 = self.text_csplayers[2](fpn[2] + self.downsample_convs[1](n4),
                                    text, **kw)
        return [n3, n4, n5], text


class MaxSigmoidAttnBlock(nn.Module):
    """YOLO-World's multi-head max-sigmoid text attention at c channels.
    With guide = guide_fc(text) (B, N, heads, c / heads) and x viewed as
    (B, heads, c / heads, H, W):

        w[b, m, h, w] = sigmoid(max_n sum_k x[b, m, k, h, w]
                                         guide[b, n, m, k] / sqrt(c / heads)
                                + bias[m])

    and the output is project_conv(x) (3x3 conv + BatchNorm, no SiLU) with
    head m's channels scaled by w[b, m]. Masked-out classes get -inf before
    the max. The scores are fp32 from the compute-dtype operands, as
    `TextGuidedCSPLayer`'s. mmyolo embeds x with a 1x1 conv where its
    embedding width differs from c; at every published width it equals c
    (half of the level's width), so the block has no such conv."""

    def __init__(self, c: int, guide_dim: int, heads: int,
                 quant: str = 'none'):
        super().__init__()
        if c % heads:
            raise ValueError(f'max-sigmoid attention: {heads} heads do not '
                             f'divide {c} channels')
        self.heads, self.head_channels = heads, c // heads
        self.guide_fc = nn.Linear(guide_dim, c)
        self.bias = nn.Parameter(torch.zeros(heads))
        self.project_conv = ConvBlock(c, c, 3, quant=quant, act=False)

    def weights(self, x: torch.Tensor, text: torch.Tensor,
                class_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, heads, H, W) fp32 gate of x (B, c, H, W) against text
        (B, N, guide_dim)."""
        B, _, H, W = x.shape
        m, c = self.heads, self.head_channels
        guide = self.guide_fc(text.to(self.guide_fc.weight.dtype))
        with torch.autocast(x.device.type, enabled=False):
            att = torch.einsum(
                'bmchw,bnmc->bmhwn',
                at_least_fp32(x).reshape(B, m, c, H, W),
                at_least_fp32(guide).reshape(B, -1, m, c))
        if class_mask is not None:
            att = att.masked_fill(~class_mask[:, None, None, None, :],
                                  float('-inf'))
        att = att.amax(dim=-1) / math.sqrt(c)
        return torch.sigmoid(att + self.bias.float()[None, :, None, None])

    def forward(self, x: torch.Tensor, text: torch.Tensor,
                class_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, _, H, W = x.shape
        w = self.weights(x, text, class_mask)
        y = self.project_conv(x)
        y = y.reshape(B, self.heads, -1, H, W) * w[:, :, None].to(y.dtype)
        return y.reshape(B, -1, H, W)


class MaxSigmoidCSPLayer(C2fLayer):
    """mmyolo's `MaxSigmoidCSPLayerWithTwoConv`: a C2f block (no
    shortcuts) whose last chunk also goes through a `MaxSigmoidAttnBlock`
    at mid channels, HEAD_CHANNELS a head, appended before `final_conv`
    ((3 + n) mid channels). `stage` names its graph marks."""

    def __init__(self, cin: int, cout: int, n: int, guide_dim: int,
                 stage: str, quant: str = 'none'):
        super().__init__(cin, cout, n, False, quant, extra=1)
        self.attn_block = MaxSigmoidAttnBlock(
            self.mid, guide_dim, self.mid // HEAD_CHANNELS, quant)
        self.stage = stage

    def forward(self, x: torch.Tensor, text: torch.Tensor,
                class_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        out = self.chunks(x)
        profiling.mark('neck_convs.' + self.stage)
        out.append(self.attn_block(out[-1], text, class_mask))
        profiling.mark('text_attn.' + self.stage)
        return self.final_conv(torch.cat(out, dim=1))


class YOLOWorldPAFPN(nn.Module):
    """YOLO-World v2's neck over (c3, c4, c5), widths in = out =
    `channels`, n the C2f blocks a layer. `top_down_layers[0]` makes P4,
    `[1]` P3; `bottom_up_layers[0]` P4, `[1]` P5, as mmyolo's YOLOv8PAFPN
    orders them."""

    def __init__(self, channels: Sequence[int], guide_dim: int, n: int,
                 quant: str = 'none'):
        super().__init__()
        c, q = list(channels), quant

        def layer(cin, lvl, stage):
            return MaxSigmoidCSPLayer(cin, c[lvl], n, guide_dim, stage, q)
        self.top_down_layers = nn.ModuleList(
            [layer(c[1] + c[2], 1, 'top_down.0'),
             layer(c[0] + c[1], 0, 'top_down.1')])
        self.downsample_layers = nn.ModuleList(
            ConvBlock(c[i], c[i], 3, 2, quant=q) for i in range(2))
        self.bottom_up_layers = nn.ModuleList(
            [layer(c[0] + c[1], 1, 'bottom_up.0'),
             layer(c[1] + c[2], 2, 'bottom_up.1')])

    def forward(self, features: Sequence[torch.Tensor], text: torch.Tensor,
                class_mask: Optional[torch.Tensor] = None
                ) -> List[torch.Tensor]:
        """features (c3, c4, c5); text (B, N, guide_dim) as given (the
        text model's normalised rows) -> [n3, n4, n5]."""
        c3, c4, c5 = features
        up = functools.partial(F.interpolate, scale_factor=2, mode='nearest')
        p4 = self.top_down_layers[0](torch.cat([up(c5), c4], 1), text,
                                     class_mask)
        n3 = self.top_down_layers[1](torch.cat([up(p4), c3], 1), text,
                                     class_mask)
        n4 = self.bottom_up_layers[0](
            torch.cat([self.downsample_layers[0](n3), p4], 1), text,
            class_mask)
        n5 = self.bottom_up_layers[1](
            torch.cat([self.downsample_layers[1](n4), c5], 1), text,
            class_mask)
        return [n3, n4, n5]
