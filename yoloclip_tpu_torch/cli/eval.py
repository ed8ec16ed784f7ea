"""Standalone evaluation CLI: score a checkpoint on a COCO val set through
the serving path. Counterpart of `yoloclip_tpu/cli/eval.py`, with its flag
surface; --device picks the card ('cuda', the default: the similarity and
NMS kernels) or the CPU.

Each image goes through `YOLOCLIPDetector.detect` (host letterbox ->
forward -> confidence threshold -> class-agnostic NMS -> rescale to the
original pixels) and is matched against the raw COCO ground truth in
original-image coordinates, so the number describes what `detect()`
serves.

Usage:
    python -m yoloclip_tpu_torch.cli.eval --anno val.json --images val/ \
        --model final_model.pt [--classes cat,dog] [--int8] [--compat] \
        [--coco-json results.json]

Class names default to the annotation file's categories (sorted by id).
--model takes a torch state dict or a training checkpoint (its EMA weights
when it tracked them). `--compat` also reports the original evaluator's
numbers (utils/metrics.py::calculate_map_compat).
"""

from __future__ import annotations

import argparse
import logging
import os
from typing import List, Optional

import numpy as np

logger = logging.getLogger('yoloclip_tpu_torch.eval')


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(
        description='Evaluate a YOLO-CLIP checkpoint on a COCO val set '
                    '(real serving path: conf threshold + NMS)')
    p.add_argument('--anno', type=str, required=True,
                   help='COCO annotation JSON')
    p.add_argument('--images', type=str, required=True,
                   help='Image directory')
    p.add_argument('--config', type=str, default=None,
                   help='YAML inference config')
    p.add_argument('--model', type=str, default=None,
                   help='Detector weights: a torch state dict or training '
                        'checkpoint (random init if omitted)')
    p.add_argument('--vocab', type=str, default=None,
                   help='Vocabulary JSON')
    p.add_argument('--classes', type=str, default=None,
                   help='Comma-separated class names (default: the '
                        'annotation categories sorted by id)')
    p.add_argument('--conf', type=float, default=None,
                   help='Confidence threshold')
    p.add_argument('--iou', type=float, default=None,
                   help='NMS IoU threshold')
    p.add_argument('--backbone', type=str, default=None,
                   help='Backbone variant (n/s/m/l/x)')
    p.add_argument('--int8', action='store_true',
                   help='evaluate the W8A8 selective-int8 deploy graph '
                        '(calibrated on the first 8 val images)')
    p.add_argument('--compat', action='store_true',
                   help='also report the original evaluator\'s numbers '
                        '(calculate_map_compat)')
    p.add_argument('--per-class', action='store_true',
                   help='also print AP@50 / AP@50-95 per class')
    p.add_argument('--coco-json', type=str, default=None,
                   help='write detections as standard COCO results JSON '
                        '(dataset category ids)')
    p.add_argument('--limit', type=int, default=None,
                   help='evaluate only the first N images')
    p.add_argument('--text-checkpoint', type=str, default=None,
                   help='Converted CLIP text-tower weights (.npz/.pt)')
    p.add_argument('--device', type=str, default='cuda',
                   help="'cuda' (the kernels) or 'cpu' (their plain "
                        'versions)')
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> int:
    logging.basicConfig(level=logging.INFO)
    args = parse_args(argv)

    import dataclasses

    from yoloclip_tpu_torch.config import InferenceConfig, load_config
    from yoloclip_tpu_torch.data.coco import CocoIndex, _imread_rgb
    from yoloclip_tpu_torch.inference.detector import YOLOCLIPDetector
    from yoloclip_tpu_torch.utils.metrics import (calculate_map,
                                            calculate_map_compat,
                                            detections_to_coco_results,
                                            save_coco_results)

    index = CocoIndex(args.anno)
    if args.classes:
        class_names = [c.strip() for c in args.classes.split(',')]
    else:
        class_names = [index.categories[cid]['name']
                       for cid in sorted(index.categories)]
    name_to_class = {n: i for i, n in enumerate(class_names)}
    cat_to_class = {cid: name_to_class[c['name']]
                    for cid, c in index.categories.items()
                    if c['name'] in name_to_class}
    class_to_cat = {v: k for k, v in cat_to_class.items()}

    cfg = load_config(InferenceConfig, args.config)
    overrides = {'class_names': tuple(class_names)}
    if args.model:
        overrides['model_path'] = args.model
    if args.vocab:
        overrides['vocab_path'] = args.vocab
    if args.conf is not None:
        overrides['conf_threshold'] = args.conf
    if args.iou is not None:
        overrides['iou_threshold'] = args.iou
    cfg = dataclasses.replace(cfg, **overrides)
    if args.backbone:
        cfg = dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model,
                                           backbone_variant=args.backbone))

    # images that carry at least one in-vocabulary annotation, like the
    # training dataset's filter (data/coco.py), checked before the model
    # is built
    image_ids = [i for i in sorted(index.images)
                 if any(a['category_id'] in cat_to_class
                        for a in index.anns_by_image.get(i, []))]
    if args.limit:
        image_ids = image_ids[:args.limit]
    if not image_ids:
        logger.error('no annotated images for classes %s', class_names)
        return 1

    detector = YOLOCLIPDetector(
        cfg, vocab_path=cfg.vocab_path, model_path=cfg.model_path,
        text_checkpoint=args.text_checkpoint, device=args.device)

    if args.int8:
        calib = np.stack([
            detector._host_letterbox(_imread_rgb(os.path.join(
                args.images, index.images[i]['file_name'])))[0]
            for i in image_ids[:8]])
        detector.quantize_int8(calib)

    preds_all, targets_all, coco_rows = [], [], []
    for n, img_id in enumerate(image_ids, 1):
        info = index.images[img_id]
        path = os.path.join(args.images, info['file_name'])
        dets = detector.detect(path)
        if args.coco_json:
            coco_rows.extend(detections_to_coco_results(
                dets, img_id, category_ids=class_to_cat))
        pb = np.asarray([d['box'] for d in dets], np.float64).reshape(-1, 4)
        preds_all.append({
            'boxes': pb[None],
            'scores': np.asarray([d['score'] for d in dets],
                                 np.float64)[None],
            'class_ids': np.asarray([d['class_id'] for d in dets],
                                    np.int64)[None]})
        gt_boxes, gt_cls = [], []
        for ann in index.anns_by_image.get(img_id, []):
            if ann['category_id'] not in cat_to_class:
                continue
            x, y, w, h = ann['bbox']                    # COCO xywh, px
            gt_boxes.append([x, y, x + w, y + h])
            gt_cls.append(cat_to_class[ann['category_id']])
        tb = np.asarray(gt_boxes, np.float64).reshape(-1, 4)
        targets_all.append({
            'boxes': tb[None],
            'class_ids': np.asarray(gt_cls, np.int64)[None],
            'valid_mask': np.ones((1, len(gt_cls)), bool)})
        if n % 50 == 0:
            logger.info('%d/%d images', n, len(image_ids))

    map50, map50_95 = calculate_map(preds_all, targets_all,
                                    num_classes=len(class_names))
    print(f'images: {len(image_ids)}  classes: {len(class_names)}')
    print(f'mAP@50: {map50:.4f}  mAP@50-95: {map50_95:.4f}')
    if args.per_class:
        from yoloclip_tpu_torch.utils.metrics import ap_per_class_at_iou
        thresholds = np.arange(0.5, 1.0, 0.05)
        for c, name in enumerate(class_names):
            per_iou = [ap_per_class_at_iou(preds_all, targets_all, c, t)
                       for t in thresholds]
            per_iou = [a for a in per_iou if not np.isnan(a)]
            if not per_iou:
                print(f'  {name:24s} (no ground truth)')
                continue
            ap50 = ap_per_class_at_iou(preds_all, targets_all, c, 0.5)
            print(f'  {name:24s} AP@50 {ap50:.4f}  '
                  f'AP@50-95 {float(np.mean(per_iou)):.4f}')
    if args.compat:
        c50, c50_95 = calculate_map_compat(preds_all, targets_all)
        print(f'reference-compat evaluator: mAP@50 {c50:.4f}  '
              f'mAP@50-95 {c50_95:.4f}')
    if args.coco_json:
        save_coco_results(args.coco_json, coco_rows)
        logger.info('wrote %d COCO results entries to %s',
                    len(coco_rows), args.coco_json)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
