"""RepVL-PAN neck. Counterpart of `yoloclip_tpu/models/neck.py`.

  * Image-pooling attention first: a 3x3 adaptive max pool per level gives
    27 patch tokens, projected to the text width; 8-head attention with the
    text as query; residual add. From here on the text is per image.
  * FPN top-down: channel-keeping 1x1 laterals, nearest x2 upsample, 1x1
    channel adjust, ADD.
  * 3x3 FPN convs, then bottom-up PAN with stride-2 downsampling and a
    text-guided CSP layer at each level, with max-sigmoid text attention
    after every bottleneck.
"""

from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from yoloclip_tpu_torch.models.layers import (ConvBlock, DarkBottleneck,
                                              MultiHeadAttention)


class TextGuidedCSPLayer(nn.Module):
    def __init__(self, cin: int, cout: int, n_bottlenecks: int,
                 text_dim: int):
        super().__init__()
        c_ = cout // 2
        self.cv1 = ConvBlock(cin, c_, 1)
        self.cv2 = ConvBlock(cin, c_, 1)
        self.cv3 = ConvBlock(2 * c_, cout, 1)
        self.bottlenecks = nn.ModuleList(
            DarkBottleneck(c_, c_, True) for _ in range(n_bottlenecks))
        self.text_proj = nn.Linear(text_dim, c_)

    def forward(self, x: torch.Tensor, text: torch.Tensor) -> torch.Tensor:
        """x (B, Cin, H, W); text (B, N, text_dim)."""
        y1 = self.cv1(x)
        proj = self.text_proj(text.to(self.text_proj.weight.dtype))
        for m in self.bottlenecks:
            y1 = m(y1)
            # max over classes of feat . projected text, then a sigmoid gate
            scores = torch.einsum('bchw,bnc->bnhw', y1, proj)
            gate = torch.sigmoid(scores.amax(dim=1, keepdim=True).float())
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
            pooled = F.adaptive_max_pool2d(fm, (3, 3))      # (B, C, 3, 3)
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
                 n_bottlenecks: int = 1):
        super().__init__()
        ic, oc = in_channels, out_channels
        self.image_pooling_attention = ImagePoolingAttention(ic, text_dim)
        self.lateral_convs = nn.ModuleList(
            ConvBlock(ic[i], ic[i], 1) for i in range(3))
        self.up_channels = nn.ModuleList(
            [ConvBlock(ic[2], ic[1], 1), ConvBlock(ic[1], ic[0], 1)])
        self.fpn_convs = nn.ModuleList(
            ConvBlock(ic[i], oc[i], 3) for i in range(3))
        self.text_csplayers = nn.ModuleList(
            TextGuidedCSPLayer(oc[i], oc[i], n_bottlenecks, text_dim)
            for i in range(3))
        self.downsample_convs = nn.ModuleList(
            [ConvBlock(oc[0], oc[1], 3, 2), ConvBlock(oc[1], oc[2], 3, 2)])

    def forward(self, features: Sequence[torch.Tensor], text: torch.Tensor
                ) -> Tuple[List[torch.Tensor], torch.Tensor]:
        """features (c3, c4, c5); text (B, N, text_dim) ->
        ([n3, n4, n5], per-image text after I-Pool)."""
        text = self.image_pooling_attention(text, features)

        lat = [conv(f) for conv, f in zip(self.lateral_convs, features)]
        p5 = lat[2]
        up = functools.partial(F.interpolate, scale_factor=2, mode='nearest')
        p4 = lat[1] + self.up_channels[0](up(p5))
        p3 = lat[0] + self.up_channels[1](up(p4))
        fpn = [conv(p) for conv, p in zip(self.fpn_convs, (p3, p4, p5))]

        n3 = self.text_csplayers[0](fpn[0], text)
        n4 = self.text_csplayers[1](fpn[1] + self.downsample_convs[0](n3),
                                    text)
        n5 = self.text_csplayers[2](fpn[2] + self.downsample_convs[1](n4),
                                    text)
        return [n3, n4, n5], text
