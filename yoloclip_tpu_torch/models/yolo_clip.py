"""Composite YOLO-CLIP detection model. Counterpart of
`yoloclip_tpu/models/yolo_clip.py`.

backbone -> RepVL-PAN (text fused both ways) -> per-level contrastive heads
scored against the per-image text -> separate BoxHead with the DFL decode.
Text is an input, (C, E) or (B, C, E); the text tower is not part of the
graph. Scores are raw cosine values (no sigmoid).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn

from yoloclip_tpu.config import ModelConfig
from yoloclip_tpu_torch.models.backbone import YOLOv8Backbone
from yoloclip_tpu_torch.models.heads import (BoxHead, TextContrastiveHead,
                                             decode_boxes, flatten_levels)
from yoloclip_tpu_torch.models.layers import MultiHeadAttention
from yoloclip_tpu_torch.models.neck import RepVLPAN
from yoloclip_tpu_torch.ops.kernels.similarity import (
    fused_projected_similarity_argmax)


class YOLOCLIP(nn.Module):
    def __init__(self, cfg: ModelConfig = ModelConfig(),
                 with_aux_box: bool = False):
        """with_aux_box: build the contrastive heads' auxiliary box towers
        (weights only) -- set it when the state dict carries them."""
        super().__init__()
        if cfg.quant != 'none' or cfg.stem_s2d or cfg.stem_u8_s2d:
            raise NotImplementedError(
                'int8 and the space-to-depth stems are not ported yet '
                '(ROADMAP.md, queue A: int8 deploy)')
        self.cfg = cfg
        fc = cfg.feature_channels()
        self.backbone = YOLOv8Backbone(cfg)
        self.neck = RepVLPAN(fc, fc, cfg.embed_dim, cfg.neck_bottlenecks)
        self.contrastive_heads = nn.ModuleList(
            TextContrastiveHead(c, cfg.embed_dim, cfg.hidden_dim, cfg.reg_max,
                                cfg.cls_alpha, cfg.cls_beta, with_aux_box)
            for c in fc)
        self.box_head = BoxHead(fc, cfg.hidden_dim, cfg.reg_max)

    def forward(self, images: torch.Tensor, text: torch.Tensor,
                fused_scores: bool = False) -> Dict[str, torch.Tensor]:
        """images (B, H, W, 3) float in [0, 1] (the JAX layout; permuted
        here to a channels_last NCHW view); text (C, E) or (B, C, E).

        fused_scores=True scores through the folded similarity kernel per
        level and returns neither `similarity` (B, A, C) nor
        `obj_embeddings` (B, A, E): eager PyTorch has no dead-code
        elimination, so they are not computed at all."""
        cfg = self.cfg
        dt = self.box_head.box_convs[0][2].weight.dtype
        B = images.shape[0]
        x = images.permute(0, 3, 1, 2).to(dt).contiguous(
            memory_format=torch.channels_last)
        if text.dim() == 2:
            text = text[None].expand(B, -1, -1)
        text = text.float()
        use_fused = fused_scores and cfg.cls_alpha > 0

        feats = self.backbone(x)
        pan, text = self.neck(feats, text)

        out: Dict[str, torch.Tensor] = {}
        if use_fused:
            txt_n = text / torch.linalg.vector_norm(
                text, dim=-1, keepdim=True).clamp_min(1e-12)
            fold_s, fold_ids = [], []
            for head, feat in zip(self.contrastive_heads, pan):
                h, k, b = head(feat, return_hidden=True)
                # (B, hidden, H, W) channels_last -> (B, H*W, hidden) rows
                hr = h.permute(0, 2, 3, 1).reshape(B, -1, h.shape[1])
                s, ids = fused_projected_similarity_argmax(hr, txt_n, k, b)
                fold_s.append(s)
                fold_ids.append(ids)
            scores = cfg.cls_alpha * torch.cat(fold_s, dim=1) + cfg.cls_beta
            class_ids = torch.cat(fold_ids, dim=1)
        else:
            objs = [head(feat) for head, feat in
                    zip(self.contrastive_heads, pan)]
            sims = [head.compute_similarity(o, text)
                    for head, o in zip(self.contrastive_heads, objs)]
            similarity = torch.cat(sims, dim=1)               # (B, A, C)
            scores, class_ids = similarity.max(dim=-1)
            class_ids = class_ids.to(torch.int32)
            out['similarity'] = similarity
            out['obj_embeddings'] = flatten_levels(objs).float()

        box_preds = self.box_head(pan)
        out.update({
            'boxes': decode_boxes(box_preds, cfg.strides, cfg.reg_max),
            'scores': scores,
            'class_ids': class_ids,
            'text_embeddings': text.float(),
            'box_preds': [p.permute(0, 2, 3, 1) for p in box_preds],
        })
        return out


def init_weights(model: YOLOCLIP, generator: torch.Generator) -> None:
    """Random init from an explicit generator (the bring-up mode when no
    checkpoint is given), in the spirit of flax's defaults: lecun-normal
    conv and linear weights, zero biases, identity BatchNorm, xavier-uniform
    attention projections.

    One prior on top: the BoxHead's last convs get the bias -k on DFL bin
    k. With zero biases the bins come out near uniform, every offset near
    8, and exp(8)*stride boxes cover the whole frame, so NMS would keep one
    box per image; with the prior, random-init boxes come out at object
    scale and overlap like real candidates."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                fan_in = m.weight[0].numel()
                m.weight.normal_(0.0, 1.0 / math.sqrt(fan_in),
                                 generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
            elif isinstance(m, MultiHeadAttention):
                w = m.in_proj_weight
                bound = math.sqrt(6.0 / (w.shape[0] + w.shape[1]))
                w.uniform_(-bound, bound, generator=generator)
                m.in_proj_bias.zero_()
        nbins = model.cfg.reg_max + 1
        prior = -torch.arange(nbins, dtype=torch.float32).repeat(4)
        for tower in model.box_head.box_convs:
            tower[2].bias.copy_(prior)


def build_model(cfg: ModelConfig, state_dict: Optional[dict] = None,
                seed: int = 0) -> YOLOCLIP:
    """A YOLOCLIP in eval mode on the CPU, in fp32: weights from a
    reference-layout state dict (strict), or random from `seed`."""
    aux = state_dict is not None and (
        'contrastive_heads.0.box_conv.0.conv.weight' in state_dict)
    model = YOLOCLIP(cfg, with_aux_box=aux)
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    else:
        init_weights(model, torch.Generator().manual_seed(seed))
    return model.eval()
