"""Training losses. Counterpart of `yoloclip_tpu/train/losses.py`: the same
math on torch tensors, every loss in fp32 whatever the compute dtype.

  * region_text_contrastive_loss: the original repo's region-text CE with
    its quirks kept (each documented below).
  * iou_family / iou_loss: IoU, GIoU, DIoU and CIoU (alpha not detached).
  * distributed_focal_loss, dfl_soft_targets, soft_dfl_loss: DFL.
  * region_text_bce_loss: per-class sigmoid BCE over every anchor.
  * combined_loss_compat: the original trainer's objective, where only the
    first `max_objects` anchors train, paired index-wise with the padded
    ground truth, and the DFL term is 0.
  * combined_loss_clean: top-k center assignment (`train/assign.py`),
    contrastive (BCE or softmax), CIoU over assigned boxes, real DFL.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from yoloclip_tpu_torch.train.assign import (assign_batch,
                                             dfl_targets_from_boxes)


def _l2norm(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1,
                                        keepdim=True).clamp_min(eps)


def region_text_contrastive_loss(
        region_features: torch.Tensor,       # (B, R, E)
        text_embeddings: torch.Tensor,       # (B, C, E)
        region_labels: torch.Tensor,         # (B, M) int or (B, M, C)
        valid_mask: Optional[torch.Tensor] = None,   # (B, M) bool
        temperature: float = 0.1,
        topk: int = 3,
        label_smoothing: float = 0.0,
        reduction: str = 'mean') -> torch.Tensor:
    """Region-text contrastive loss with the original repo's quirks:

      * regions are truncated / zero-padded to M = region_labels.shape[1]
        (with M = 100 only the first 100 anchors train);
      * labels >= C are zeroed and masked out;
      * top-k positive weighting: pos_weight = sum of the top-k of
        (similarity * labels) / floor(min positive count over the batch),
        with gradients through the weight;
      * 'mean' divides by the EXPANDED mask sum (n_valid * C).
    """
    B, R, E = region_features.shape
    C = text_embeddings.shape[1]
    M = region_labels.shape[1]

    if R >= M:
        region = region_features[:, :M, :]
    else:
        pad = region_features.new_zeros((B, M - R, E))
        region = torch.cat([region_features, pad], dim=1)
        if valid_mask is not None:
            valid_mask = torch.cat(
                [valid_mask, valid_mask.new_zeros((B, M - R))], dim=1)

    region = _l2norm(region.float())
    text = _l2norm(text_embeddings.float())
    similarity = torch.einsum('bme,bce->bmc', region, text)
    logits = similarity / temperature

    if region_labels.dim() == 2:
        invalid = region_labels >= C
        labels_idx = torch.where(invalid, torch.zeros_like(region_labels),
                                 region_labels)
        valid_mask = (~invalid if valid_mask is None
                      else valid_mask.bool() & ~invalid)
        labels_oh = F.one_hot(labels_idx.long(), C).float()
    else:
        labels_oh = region_labels.float()

    if label_smoothing > 0:
        labels_oh = (1 - label_smoothing) * labels_oh + label_smoothing / C

    if valid_mask is None:
        valid_mask = torch.ones((B, M), dtype=torch.bool,
                                device=region.device)

    if topk > 1:
        pos_sim = similarity * labels_oh
        k = min(topk, C)
        topk_vals = torch.topk(pos_sim, k, dim=-1).values
        pos_count_min = labels_oh.sum(-1).min().clamp_min(1)
        topk_min = torch.clamp(torch.floor(pos_count_min), max=float(topk))
        pos_weight = topk_vals.sum(-1, keepdim=True) / topk_min
        weighted_labels = labels_oh * pos_weight
    else:
        weighted_labels = labels_oh

    log_probs = torch.log_softmax(logits, dim=-1)
    loss = -(weighted_labels * log_probs)                   # (B, M, C)
    mask3 = valid_mask[..., None].expand(loss.shape).float()
    loss = loss * mask3
    pos_count = labels_oh.sum(-1).clamp_min(1)
    loss = loss.sum(-1) / pos_count                         # (B, M)

    if reduction == 'mean':
        denom = mask3.sum()
        return torch.where(denom > 0, loss.sum() / denom.clamp_min(1e-30),
                           torch.zeros_like(denom))
    if reduction == 'sum':
        return loss.sum()
    return loss


def iou_family(pred: torch.Tensor, target: torch.Tensor,
               iou_type: str = 'ciou', eps: float = 1e-7
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(iou, loss) per box pair; pred/target (..., 4) xyxy. Areas
    unclamped, intersection w/h clamped at 0, CIoU's alpha NOT detached."""
    px1, py1, px2, py2 = pred.unbind(-1)
    tx1, ty1, tx2, ty2 = target.unbind(-1)
    p_area = (px2 - px1) * (py2 - py1)
    t_area = (tx2 - tx1) * (ty2 - ty1)
    iw = (torch.minimum(px2, tx2) - torch.maximum(px1, tx1)).clamp_min(0)
    ih = (torch.minimum(py2, ty2) - torch.maximum(py1, ty1)).clamp_min(0)
    inter = iw * ih
    union = p_area + t_area - inter
    iou = inter / (union + eps)
    if iou_type == 'iou':
        return iou, 1 - iou

    ex1 = torch.minimum(px1, tx1)
    ey1 = torch.minimum(py1, ty1)
    ex2 = torch.maximum(px2, tx2)
    ey2 = torch.maximum(py2, ty2)
    if iou_type == 'giou':
        enclose = (ex2 - ex1) * (ey2 - ey1)
        giou = iou - (enclose - union) / (enclose + eps)
        return iou, 1 - giou

    center_d2 = (((px1 + px2) - (tx1 + tx2)) ** 2
                 + ((py1 + py2) - (ty1 + ty2)) ** 2) / 4
    diag2 = (ex2 - ex1) ** 2 + (ey2 - ey1) ** 2
    if iou_type == 'diou':
        return iou, 1 - (iou - center_d2 / (diag2 + eps))

    if iou_type == 'ciou':
        pw, ph = px2 - px1, py2 - py1
        tw, th = tx2 - tx1, ty2 - ty1
        v = (4 / math.pi ** 2) * (torch.atan(pw / (ph + eps))
                                  - torch.atan(tw / (th + eps))) ** 2
        alpha = v / (1 - iou + v + eps)
        ciou = iou - (center_d2 / (diag2 + eps) + alpha * v)
        return iou, 1 - ciou
    raise ValueError(f'Unknown iou_type: {iou_type}')


def iou_loss(pred_boxes: torch.Tensor, target_boxes: torch.Tensor,
             weights: Optional[torch.Tensor] = None, iou_type: str = 'ciou',
             reduction: str = 'mean', eps: float = 1e-7) -> torch.Tensor:
    """Optional elementwise weights, then the mean over ALL entries
    (invalid rows count in the denominator). A 2-D weight against a 3-D
    loss is truncated / zero-padded along axis 1 and unsqueezed; a weight
    whose axis-1 width still mismatches the loss is ignored, as the
    original repo does."""
    _, loss = iou_family(pred_boxes.float(), target_boxes.float(), iou_type,
                         eps)
    if weights is not None:
        w = weights.to(loss.dtype)
        if loss.dim() == 3 and w.dim() == 2:
            if w.shape[1] > loss.shape[1]:
                w = w[:, :loss.shape[1]]
            elif w.shape[1] < loss.shape[1]:
                w = torch.cat([w, w.new_zeros(
                    (w.shape[0], loss.shape[1] - w.shape[1]))], dim=1)
            w = w[..., None]
        if not (w.dim() >= 2 and loss.dim() >= 2
                and w.shape[1] != loss.shape[1]):
            loss = loss * w
    if reduction == 'mean':
        return loss.mean()
    if reduction == 'sum':
        return loss.sum()
    return loss


def distributed_focal_loss(pred_dfl: torch.Tensor, target_bins: torch.Tensor,
                           weights: Optional[torch.Tensor] = None,
                           reg_max: int = 16,
                           reduction: str = 'mean') -> torch.Tensor:
    """Cross-entropy between bin logits (..., reg_max+1) and integer bin
    targets (...,) clipped to [0, reg_max]."""
    target = target_bins.long().clamp(0, reg_max)
    logp = torch.log_softmax(pred_dfl.float(), dim=-1)
    loss = -torch.gather(logp, -1, target[..., None])[..., 0]
    if weights is not None:
        loss = loss * weights.to(loss.dtype)
    if reduction == 'mean':
        return loss.mean()
    if reduction == 'sum':
        return loss.sum()
    return loss


def dfl_soft_targets(distances: torch.Tensor,
                     reg_max: int = 16) -> torch.Tensor:
    """Continuous distance -> two-bin soft DFL target distribution."""
    d = distances.clamp(0, reg_max - 1e-3)
    lo = torch.floor(d)
    w_hi = d - lo
    oh_lo = F.one_hot(lo.long(), reg_max + 1).float()
    oh_hi = F.one_hot(lo.long() + 1, reg_max + 1).float()
    return oh_lo * (1 - w_hi[..., None]) + oh_hi * w_hi[..., None]


def soft_dfl_loss(pred_logits: torch.Tensor, target_cont: torch.Tensor,
                  mask: torch.Tensor, reg_max: int = 16) -> torch.Tensor:
    """Cross-entropy between per-coordinate bin logits (..., 4, reg_max+1)
    and two-bin soft targets of target_cont (..., 4), masked mean over the
    foreground (mask (...,) bool)."""
    tgt = dfl_soft_targets(target_cont, reg_max)
    logp = torch.log_softmax(pred_logits.float(), dim=-1)
    ce = -(tgt * logp).sum(-1).mean(-1)
    m = mask.float()
    return (ce * m).sum() / m.sum().clamp_min(1.0)


def region_text_bce_loss(region_features: torch.Tensor,   # (B, A, E)
                         text_embeddings: torch.Tensor,   # (B, C, E)
                         labels: torch.Tensor,            # (B, A) int
                         fg_mask: torch.Tensor,           # (B, A) bool
                         temperature: float = 0.1,
                         score_bias: float = 0.25) -> torch.Tensor:
    """Per-class sigmoid BCE over ALL anchors: one-hot(class) targets on
    assigned anchors, all-zero on background, logits centered on
    `score_bias` (the 0.25 deploy threshold on the raw-cosine scale), so
    the foreground is pushed above it and the background below.
    Normalised by the foreground count. The BCE is the log-sigmoid form
    of optax's `sigmoid_binary_cross_entropy`."""
    region = _l2norm(region_features.float())
    text = _l2norm(text_embeddings.float())
    sim = torch.einsum('bae,bce->bac', region, text)
    logits = (sim - score_bias) / temperature
    C = text.shape[1]
    tgt = F.one_hot(labels.long(), C).float() * fg_mask[..., None].float()
    per = -(tgt * F.logsigmoid(logits) + (1 - tgt) * F.logsigmoid(-logits))
    return per.sum() / fg_mask.sum().float().clamp_min(1.0)


def combined_loss_clean(outputs: Dict[str, torch.Tensor],
                        batch: Dict[str, torch.Tensor],
                        loss_weights: Dict[str, float],
                        anchors: torch.Tensor,
                        anchor_strides: torch.Tensor,
                        temperature: float = 0.1,
                        iou_type: str = 'ciou',
                        label_smoothing: float = 0.0,
                        topk_assign: int = 10,
                        reg_max: int = 16,
                        contrastive_type: str = 'bce'
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Every anchor participates: top-k center assignment -> contrastive
    ('bce', or 'softmax' over the labeled anchors), CIoU over assigned
    boxes (foreground-normalised), DFL on the inverted decode targets."""
    assigned = assign_batch(anchors, batch['boxes'], batch['class_ids'],
                            batch['valid_mask'], topk=topk_assign)
    fg = assigned['fg_mask']
    labels = torch.where(fg, assigned['cls_target'],
                         torch.zeros_like(assigned['cls_target']))

    if contrastive_type == 'bce':
        cont = region_text_bce_loss(
            outputs['obj_embeddings'], outputs['text_embeddings'],
            labels, fg, temperature=temperature)
    elif contrastive_type == 'softmax':
        cont = region_text_contrastive_loss(
            outputs['obj_embeddings'], outputs['text_embeddings'],
            labels, fg, temperature=temperature, topk=1,
            label_smoothing=label_smoothing)
    else:
        raise ValueError(
            f"contrastive_type must be 'bce' or 'softmax', "
            f'got {contrastive_type!r}')

    _, iou_l = iou_family(outputs['boxes'].float(),
                          assigned['box_target'].float(), iou_type)
    m = fg.float()
    iou = (iou_l * m).sum() / m.sum().clamp_min(1.0)

    # raw per-level NHWC maps -> (B, A, 4, nbins), level-major like decode
    B = fg.shape[0]
    pred_dist = torch.cat([p.reshape(B, -1, 4, reg_max + 1)
                           for p in outputs['box_preds']], dim=1)
    tgt = dfl_targets_from_boxes(assigned['box_target'], anchors[None],
                                 anchor_strides[None], reg_max)
    dfl = soft_dfl_loss(pred_dist, tgt, fg, reg_max)

    total = (loss_weights['contrastive'] * cont
             + loss_weights['iou'] * iou
             + loss_weights['dfl'] * dfl)
    return total, {'loss': total, 'contrastive_loss': cont,
                   'iou_loss': iou, 'dfl_loss': dfl, 'num_fg': m.sum()}


def combined_loss_compat(outputs: Dict[str, torch.Tensor],
                         batch: Dict[str, torch.Tensor],
                         loss_weights: Dict[str, float],
                         temperature: float = 0.1,
                         iou_type: str = 'ciou',
                         label_smoothing: float = 0.0,
                         topk: int = 3
                         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The original trainer's objective: contrastive over the first
    max_objects anchors + CIoU over the first max_objects predicted boxes
    against the padded ground truth (weights = valid_mask, mean over all
    B*M entries) + a DFL term fixed at 0."""
    cont = region_text_contrastive_loss(
        outputs['obj_embeddings'], outputs['text_embeddings'],
        batch['class_ids'], batch.get('valid_mask'),
        temperature=temperature, topk=topk,
        label_smoothing=label_smoothing)
    M = batch['boxes'].shape[1]
    iou = iou_loss(outputs['boxes'][:, :M, :], batch['boxes'],
                   batch.get('valid_mask'), iou_type=iou_type)
    dfl = torch.zeros((), dtype=torch.float32, device=iou.device)
    total = (loss_weights['contrastive'] * cont
             + loss_weights['iou'] * iou
             + loss_weights['dfl'] * dfl)
    return total, {'loss': total, 'contrastive_loss': cont,
                   'iou_loss': iou, 'dfl_loss': dfl}
