"""Composite YOLO-CLIP detection model. Counterpart of
`yoloclip_tpu/models/yolo_clip.py`.

backbone -> RepVL-PAN (text fused both ways) -> per-level contrastive heads
scored against the per-image text -> separate BoxHead with the DFL decode.
Text is an input, (C, E) or (B, C, E); the text tower is not part of the
graph. Scores are raw cosine values (no sigmoid). `cfg.quant='int8'` builds
the W8A8 deploy graph (`ops/quantize.py` makes its state dict);
`cfg.stem_s2d` / `cfg.stem_u8_s2d` the space-to-depth stems.

Two partitions of one forward, each running this forward once a shard:
  * a class shard (`class_shard`, the mesh's 'model' axis): the text is
    the shard's block of classes; the neck's class max and each level's
    (score, id) are merged over the axis, the unfused similarity stays the
    shard's (B, A, size) block;
  * a height partition (`parallel/spatial.py`): the convs exchange halo
    rows, and the heads' maps are gathered in global row order before the
    anchor tail, which then runs on every shard alike.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn

from yoloclip_tpu_torch.config import ModelConfig
from yoloclip_tpu_torch.models.backbone import YOLOv8Backbone
from yoloclip_tpu_torch.models.heads import (BoxHead, TextContrastiveHead,
                                             decode_boxes, flatten_levels)
from yoloclip_tpu_torch.models.heads import Proj1x1
from yoloclip_tpu_torch.models.layers import (ConvBlock, MultiHeadAttention,
                                              _ConvKernel, at_least_fp32)
from yoloclip_tpu_torch.models.neck import RepVLPAN
from yoloclip_tpu_torch.ops.kernels.similarity import (
    NEG, fused_projected_similarity_argmax,
    sharded_projected_similarity_argmax)
from yoloclip_tpu_torch.parallel import spatial
from yoloclip_tpu_torch.parallel.collectives import ClassShard, merge_argmax
from yoloclip_tpu_torch.utils import profiling


class YOLOCLIP(nn.Module):
    def __init__(self, cfg: ModelConfig = ModelConfig(),
                 with_aux_box: bool = False):
        """with_aux_box: build the contrastive heads' auxiliary box towers
        (weights only) -- set it when the state dict carries them."""
        super().__init__()
        if cfg.quant not in ('none', 'int8'):
            raise ValueError(
                f"ModelConfig.quant must be 'none' or 'int8', got "
                f"{cfg.quant!r}: calibration runs the float model under "
                'forward hooks (ops/quantize.py::calibrate_amax)')
        self.cfg = cfg
        fc, q = cfg.feature_channels(), cfg.quant
        self.backbone = YOLOv8Backbone(cfg)
        self.neck = RepVLPAN(fc, fc, cfg.embed_dim, cfg.neck_bottlenecks, q)
        self.contrastive_heads = nn.ModuleList(
            TextContrastiveHead(c, cfg.embed_dim, cfg.hidden_dim, cfg.reg_max,
                                cfg.cls_alpha, cfg.cls_beta, with_aux_box, q)
            for c in fc)
        self.box_head = BoxHead(fc, cfg.hidden_dim, cfg.reg_max, q)
        for name, m in self.named_modules():
            if isinstance(m, ConvBlock):
                m.block_name = name

    def forward(self, images: torch.Tensor, text: torch.Tensor,
                fused_scores: bool = False,
                class_mask: Optional[torch.Tensor] = None,
                skip_image_pool: bool = False,
                class_shard: Optional[ClassShard] = None
                ) -> Dict[str, torch.Tensor]:
        """images (B, H, W, 3) float in [0, 1] (the JAX layout; permuted
        here to a channels_last NCHW view), or under cfg.stem_u8_s2d the
        (B, H/2, W/2, 12) uint8 space-to-depth canvas; text (C, E) or
        (B, C, E).

        fused_scores=True scores through the folded similarity kernel per
        level and returns neither `similarity` (B, A, C) nor
        `obj_embeddings` (B, A, E): eager PyTorch has no dead-code
        elimination, so they are not computed at all. The kernel takes no
        mask, so a class_mask always takes the unfused path.

        class_mask: (C,) or (B, C) bool, or None; masked-out classes get
        -inf in every text-guided CSP layer's max and in the similarity.
        skip_image_pool: the text skips I-Pool (`RepVLPAN.forward`).
        class_shard: text (and class_mask) are this shard's block of the
        classes; scores and class_ids come out global (ids over the whole
        vocabulary), `similarity` and `text_embeddings` the block's."""
        cfg = self.cfg
        dt = self.box_head.box_convs[0][2].weight.dtype
        B = images.shape[0]
        x = images.permute(0, 3, 1, 2).to(dt).contiguous(
            memory_format=torch.channels_last)
        if text.dim() == 2:
            text = text[None].expand(B, -1, -1)
        text = at_least_fp32(text)
        if class_mask is not None:
            class_mask = class_mask.to(device=text.device, dtype=torch.bool)
            if class_mask.dim() == 1:
                class_mask = class_mask[None].expand(B, -1)
        # alpha > 0 strictly: argmax(alpha*s+beta) == argmax(s) needs it
        use_fused = (fused_scores and class_mask is None
                     and cfg.cls_alpha > 0)

        feats = self.backbone(x)
        profiling.mark('backbone')
        pan, text = self.neck(feats, text, class_mask, skip_image_pool,
                              class_shard)
        profiling.mark('neck')

        out: Dict[str, torch.Tensor] = {}
        if use_fused:
            txt_n = text / torch.linalg.vector_norm(
                text, dim=-1, keepdim=True).clamp_min(1e-12)
            fold_s, fold_ids = [], []
            for head, feat in zip(self.contrastive_heads, pan):
                h, k, b = head(feat, return_hidden=True)
                h = spatial.gather_rows(h)
                # (B, hidden, H, W) channels_last -> (B, H*W, hidden) rows
                hr = h.permute(0, 2, 3, 1).reshape(B, -1, h.shape[1])
                if class_shard is None:
                    s, ids = fused_projected_similarity_argmax(hr, txt_n, k,
                                                               b)
                else:
                    s, ids = sharded_projected_similarity_argmax(
                        hr, txt_n, k, b, class_shard)
                fold_s.append(s)
                fold_ids.append(ids)
            scores = cfg.cls_alpha * torch.cat(fold_s, dim=1) + cfg.cls_beta
            class_ids = torch.cat(fold_ids, dim=1)
        else:
            objs = [spatial.gather_rows(head(feat)) for head, feat in
                    zip(self.contrastive_heads, pan)]
            sims = [head.compute_similarity(o, text)
                    for head, o in zip(self.contrastive_heads, objs)]
            similarity = torch.cat(sims, dim=1)               # (B, A, C)
            if class_mask is not None:
                similarity = similarity.masked_fill(~class_mask[:, None, :],
                                                    float('-inf'))
            if similarity.shape[-1]:
                scores, class_ids = similarity.max(dim=-1)
            else:   # an empty class block
                scores = similarity.new_full(similarity.shape[:-1], NEG)
                class_ids = torch.zeros(similarity.shape[:-1],
                                        dtype=torch.int64,
                                        device=similarity.device)
            if class_shard is not None:
                scores, class_ids = merge_argmax(
                    scores, class_ids, class_shard.offset, class_shard.group)
            class_ids = class_ids.to(torch.int32)
            out['similarity'] = similarity
            out['obj_embeddings'] = at_least_fp32(flatten_levels(objs))

        box_preds = [spatial.gather_rows(p) for p in self.box_head(pan)]
        out.update({
            'boxes': decode_boxes(box_preds, cfg.strides, cfg.reg_max),
            'scores': scores,
            'class_ids': class_ids,
            'text_embeddings': text,
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
            if isinstance(m, (nn.Conv2d, nn.Linear, _ConvKernel)):
                fan_in = m.weight[0].numel()
                m.weight.normal_(0.0, 1.0 / math.sqrt(fan_in),
                                 generator=generator)
                if getattr(m, 'bias', None) is not None:
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


def cast_compute_dtype(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast the convs (weights also to channels_last), the linears and the
    attention projections to the compute dtype, in place. Everything else
    stays fp32, as the JAX package keeps it (`param_dtype=float32`):
    BatchNorm's affine and statistics, the obj_2 projection (`Proj1x1`, so
    the folded similarity reads the fp32 kernel), the s2d stems' kernels,
    the folded `wf`/`fbias` and the int8 scales; those are cast at use."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d) and not isinstance(m, Proj1x1):
                m.to(dtype=dtype, memory_format=torch.channels_last)
            elif isinstance(m, nn.Linear):
                m.to(dtype=dtype)
            elif isinstance(m, MultiHeadAttention):
                m.in_proj_weight.data = m.in_proj_weight.data.to(dtype)
                m.in_proj_bias.data = m.in_proj_bias.data.to(dtype)
    return model


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
