"""YOLOv8 CSPDarknet backbone. Counterpart of `yoloclip_tpu/models/backbone.py`.

Stem + four stages, each opening with a stride-2 conv; SPPF closes stage 4.
Returns (c3, c4, c5) at strides 8/16/32. Module names follow the reference
torch layout: `stage{s}.0` conv, `stage{s}.1` CSP layer, `stage4.2` SPPF.
`cfg.stem_s2d` runs the stem over the space-to-depth layout;
`cfg.stem_u8_s2d` takes the (B, 12, H/2, W/2) 0..255 canvas as input.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from yoloclip_tpu_torch.config import ModelConfig
from yoloclip_tpu_torch.models.layers import SPPF, ConvBlock, CSPLayer


class YOLOv8Backbone(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        ch = cfg.backbone_channels()
        dp = cfg.backbone_depths()
        q = cfg.quant
        self.stem = ConvBlock(3, ch[0], 3, 2, quant=q, s2d=cfg.stem_s2d,
                              s2d_pre=cfg.stem_u8_s2d)
        for s in range(1, 5):
            layers = [ConvBlock(ch[s - 1], ch[s], 3, 2, quant=q),
                      CSPLayer(ch[s], ch[s], dp[s - 1], q)]
            if s == 4:
                layers.append(SPPF(ch[4], ch[4], 5, q))
            setattr(self, f'stage{s}', nn.Sequential(*layers))

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """x: (B, 3, H, W), or (B, 12, H/2, W/2) under stem_u8_s2d ->
        (c3, c4, c5)."""
        x = self.stage1(self.stem(x))
        c3 = self.stage2(x)
        c4 = self.stage3(c3)
        c5 = self.stage4(c4)
        return c3, c4, c5
