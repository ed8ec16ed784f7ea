"""Detection metrics: COCO-style mAP and the original repo's evaluator.
The port's numpy copy of `yoloclip_tpu/utils/metrics.py`.

`calculate_map` is greedy per-class matching with the all-points PR
envelope, the authoritative metric. `calculate_map_compat` reproduces the
original evaluator's semantics for numbers comparable with runs of the
original repo: per-BATCH matching, deletion of matched targets, a recall
denominator that shrinks to the remaining target count, the +1e-7
precision epsilon and the resort-by-recall AP. Its one divergence: the
original's `np.delete` with a float row as the index raises on any true
positive under modern numpy, so the matched row is deleted as intended.
`detections_to_coco_results` / `save_coco_results` write the standard
COCO results file.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def bbox_iou_matrix(a: np.ndarray, b: np.ndarray,
                    eps: float = 1e-7) -> np.ndarray:
    """IoU between (N,4) and (M,4) xyxy -> (N,M)."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float32)
    x1 = np.maximum(a[:, None, 0], b[None, :, 0])
    y1 = np.maximum(a[:, None, 1], b[None, :, 1])
    x2 = np.minimum(a[:, None, 2], b[None, :, 2])
    y2 = np.minimum(a[:, None, 3], b[None, :, 3])
    inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / (area_a[:, None] + area_b[None, :] - inter + eps)


def average_precision(recalls: np.ndarray, precisions: np.ndarray) -> float:
    """All-points interpolated AP (monotone precision envelope)."""
    r = np.concatenate([[0.0], recalls, [1.0]])
    p = np.concatenate([[0.0], precisions, [0.0]])
    p = np.maximum.accumulate(p[::-1])[::-1]
    idx = np.where(r[1:] != r[:-1])[0]
    return float(np.sum((r[idx + 1] - r[idx]) * p[idx + 1]))


def _match_class(preds: List[Tuple[int, float, np.ndarray]],
                 gts: Dict[int, np.ndarray],
                 iou_threshold: float) -> Tuple[np.ndarray, np.ndarray, int]:
    """Greedy per-class matching.

    preds: list of (image_idx, score, box); gts: image_idx -> (G,4) boxes.
    Returns (tp flags, fp flags, total_gt) over score-sorted predictions.
    """
    total_gt = sum(len(g) for g in gts.values())
    order = sorted(range(len(preds)), key=lambda i: -preds[i][1])
    matched = {img: np.zeros(len(g), bool) for img, g in gts.items()}
    tp = np.zeros(len(preds), np.float64)
    fp = np.zeros(len(preds), np.float64)
    for rank, i in enumerate(order):
        img, _, box = preds[i]
        g = gts.get(img)
        if g is None or len(g) == 0:
            fp[rank] = 1
            continue
        ious = bbox_iou_matrix(box[None], g)[0]
        j = int(np.argmax(ious))
        if ious[j] >= iou_threshold and not matched[img][j]:
            matched[img][j] = True
            tp[rank] = 1
        else:
            fp[rank] = 1
    return tp, fp, total_gt


def ap_per_class_at_iou(predictions: Sequence[Dict],
                        targets: Sequence[Dict],
                        class_id: int,
                        iou_threshold: float) -> float:
    """AP for one class at one IoU threshold over batched eval outputs.

    predictions/targets follow the trainer's accumulation schema: each
    entry holds per-batch arrays
    boxes (B,N,4), scores (B,N), class_ids (B,N); targets have boxes,
    class_ids and optional valid_mask.
    """
    preds: List[Tuple[int, float, np.ndarray]] = []
    gts: Dict[int, np.ndarray] = {}
    img_counter = 0
    for p_batch, t_batch in zip(predictions, targets):
        B = p_batch['boxes'].shape[0]
        for b in range(B):
            img = img_counter
            img_counter += 1
            pm = p_batch['class_ids'][b] == class_id
            for box, score in zip(p_batch['boxes'][b][pm],
                                  p_batch['scores'][b][pm]):
                preds.append((img, float(score), np.asarray(box, np.float64)))
            tm = t_batch['class_ids'][b] == class_id
            if 'valid_mask' in t_batch:
                tm = tm & t_batch['valid_mask'][b].astype(bool)
            else:
                # padded rows are all-zero boxes; drop them
                area = ((t_batch['boxes'][b][:, 2] - t_batch['boxes'][b][:, 0])
                        * (t_batch['boxes'][b][:, 3] - t_batch['boxes'][b][:, 1]))
                tm = tm & (area > 0)
            g = np.asarray(t_batch['boxes'][b][tm], np.float64)
            if len(g):
                gts[img] = g
    if not gts:
        return float('nan')
    if not preds:
        return 0.0
    tp, fp, total_gt = _match_class(preds, gts, iou_threshold)
    ctp, cfp = np.cumsum(tp), np.cumsum(fp)
    recalls = ctp / max(total_gt, 1)
    precisions = ctp / np.maximum(ctp + cfp, 1e-9)
    return average_precision(recalls, precisions)


def _compat_ap(recalls: np.ndarray, precisions: np.ndarray) -> float:
    """The original `calculate_ap`: resort by recall first (a no-op for
    nondecreasing cumsum recalls, kept anyway), then the same all-points
    envelope."""
    i = np.argsort(recalls, kind='stable')
    return average_precision(recalls[i], precisions[i])


def _compat_ap_at_iou(preds: Sequence[Dict], targets: Sequence[Dict],
                      class_id: int, iou_threshold: float) -> float:
    """The original `calculate_ap_at_iou` semantics; quirks kept (see the
    module docstring), the fatal float-index `np.delete` replaced by the
    intended matched-row deletion."""
    all_preds, all_targets = [], []
    for batch_idx in range(len(preds)):
        p, t = preds[batch_idx], targets[batch_idx]
        pm = np.asarray(p['class_ids']).reshape(-1) == class_id
        boxes = np.asarray(p['boxes'], np.float64).reshape(-1, 4)[pm]
        scores = np.asarray(p['scores'], np.float64).reshape(-1)[pm]
        tm = np.asarray(t['class_ids']).reshape(-1) == class_id
        # the original never consults valid_mask here (quirk kept:
        # padded GT rows count as real targets if their class matches)
        tboxes = np.asarray(t['boxes'], np.float64).reshape(-1, 4)[tm]
        all_preds.append(np.column_stack(
            (np.full(len(boxes), batch_idx, np.float64), boxes, scores)))
        all_targets.append(np.column_stack(
            (np.full(len(tboxes), batch_idx, np.float64), tboxes)))
    if not all_preds or not all_targets:
        return 0.0
    all_preds = np.vstack(all_preds)
    all_targets = np.vstack(all_targets)
    all_preds = all_preds[all_preds[:, -1].argsort()[::-1]]

    tp = np.zeros(len(all_preds))
    fp = np.zeros(len(all_preds))
    for i, pred in enumerate(all_preds):
        batch_idx = int(pred[0])
        # per-BATCH pools (quirk kept): a prediction may match a target
        # from a different image in the same accumulated batch entry
        in_batch = all_targets[:, 0] == batch_idx
        target_boxes = all_targets[in_batch][:, 1:5]
        if len(target_boxes) == 0:
            fp[i] = 1
            continue
        ious = bbox_iou_matrix(pred[None, 1:5], target_boxes)[0]
        j = int(np.argmax(ious))
        if ious[j] >= iou_threshold:
            # the intended semantics: consume the matched target
            row = np.flatnonzero(in_batch)[j]
            all_targets = np.delete(all_targets, row, axis=0)
            tp[i] = 1
        else:
            fp[i] = 1

    ctp, cfp = np.cumsum(tp), np.cumsum(fp)
    # quirk kept: denominator = REMAINING targets after deletion,
    # so recall inflates as targets are consumed (recall > 1 possible)
    recalls = ctp / max(len(all_targets), 1)
    precisions = ctp / (ctp + cfp + 1e-7)
    return _compat_ap(recalls, precisions)


def calculate_map_compat(preds: Sequence[Dict], targets: Sequence[Dict]
                         ) -> Tuple[float, float]:
    """Original-evaluator (mAP@50, mAP@50-95): `_compat_ap_at_iou` per
    class over linspace(0.5, 0.95, 10). NOT COCO-comparable -- use
    `calculate_map` for real numbers."""
    class_ids = set()
    for t in targets:
        class_ids.update(np.unique(np.asarray(t['class_ids'])).tolist())
    class_ids = sorted(int(c) for c in class_ids)
    if not class_ids:
        return 0.0, 0.0
    ap50 = np.zeros(len(class_ids))
    ap = np.zeros(len(class_ids))
    for i, c in enumerate(class_ids):
        ap50[i] = _compat_ap_at_iou(preds, targets, c, 0.5)
        ap[i] = np.mean([_compat_ap_at_iou(preds, targets, c, t)
                         for t in np.linspace(0.5, 0.95, 10)])
    return float(ap50.mean()), float(ap.mean())


def detections_to_coco_results(detections: Sequence[Dict], image_id: int,
                               category_ids: Dict[int, int] | None = None
                               ) -> List[Dict]:
    """detect() output -> standard COCO results entries
    `[{image_id, category_id, bbox [x, y, w, h], score}]`, for any
    external COCO evaluator.

    `category_ids` maps the model's contiguous class_id to the dataset's
    (possibly sparse) category id; identity when omitted.
    """
    out = []
    for d in detections:
        x1, y1, x2, y2 = (float(v) for v in d['box'])
        cid = int(d['class_id'])
        out.append({
            'image_id': int(image_id),
            'category_id': (category_ids[cid] if category_ids is not None
                            else cid),
            'bbox': [x1, y1, x2 - x1, y2 - y1],
            'score': float(d['score']),
        })
    return out


def save_coco_results(path: str, results: Sequence[Dict]) -> None:
    """Write a COCO results JSON (atomic rename)."""
    import json
    import os
    tmp = path + '.tmp'
    with open(tmp, 'w') as f:
        json.dump(list(results), f)
    os.replace(tmp, path)


def calculate_map(predictions: Sequence[Dict], targets: Sequence[Dict],
                  num_classes: int | None = None
                  ) -> Tuple[float, float]:
    """(mAP@50, mAP@50:95): the original entry point's signature, correct
    math."""
    if num_classes is None:
        ids = set()
        for t in targets:
            ids.update(np.unique(t['class_ids']).tolist())
        class_list = sorted(int(i) for i in ids)
    else:
        class_list = list(range(num_classes))
    iou_thresholds = np.arange(0.5, 1.0, 0.05)

    ap50, ap_all = [], []
    for c in class_list:
        per_iou = [ap_per_class_at_iou(predictions, targets, c, t)
                   for t in iou_thresholds]
        per_iou = [a for a in per_iou if not np.isnan(a)]
        if not per_iou:
            continue
        ap50.append(ap_per_class_at_iou(predictions, targets, c, 0.5))
        ap_all.append(float(np.mean(per_iou)))
    ap50 = [a for a in ap50 if not np.isnan(a)]
    if not ap50:
        return 0.0, 0.0
    return float(np.mean(ap50)), float(np.mean(ap_all))
