"""Detection CLI. Counterpart of `yoloclip_tpu/cli/detect.py`, with its
flag surface (--config --model --vocab --input --output --conf --iou
--text_prompts --classes --backbone --coco-json); --device picks the card
('cuda', the default) or the CPU.

Usage:
    python -m yoloclip_tpu_torch.cli.detect --input img.jpg --classes cat,dog
    python -m yoloclip_tpu_torch.cli.detect --input images/ \
        --text_prompts "a red car,a person" --coco-json dets.json

--int8 serves the W8A8 deploy graph, its activation scales calibrated on
up to the first 8 inputs (each letterboxed to the model canvas first).
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
from typing import List, Optional

logger = logging.getLogger('yoloclip_tpu_torch.detect')


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(
        description='Run object detection with YOLO-CLIP (PyTorch)')
    p.add_argument('--config', type=str, default=None,
                   help='Path to YAML config file')
    p.add_argument('--model', type=str, default=None,
                   help='Detector weights: a torch .pt/.pth state dict')
    p.add_argument('--vocab', type=str, default=None,
                   help='Path to vocabulary JSON')
    p.add_argument('--input', type=str, required=True,
                   help='Path to input image or directory')
    p.add_argument('--output', type=str, default=None,
                   help='Output directory')
    p.add_argument('--conf', type=float, default=None,
                   help='Confidence threshold')
    p.add_argument('--iou', type=float, default=None,
                   help='IoU threshold for NMS')
    p.add_argument('--text_prompts', type=str, default=None,
                   help='Text prompts (comma-separated) -> online mode')
    p.add_argument('--classes', type=str, default=None,
                   help='Classes to detect (comma-separated)')
    p.add_argument('--backbone', type=str, default=None,
                   help='Backbone variant (n/s/m/l/x)')
    p.add_argument('--int8', action='store_true',
                   help='serve the W8A8 selective-int8 deploy graph '
                        '(activation scales calibrated on up to the first '
                        '8 input images; with a single input, calibration '
                        'is single-image and correspondingly weaker)')
    p.add_argument('--text-checkpoint', type=str, default=None,
                   help='Converted CLIP text-tower weights (.npz/.pt)')
    p.add_argument('--device', type=str, default='cuda',
                   help="'cuda' (the kernels) or 'cpu' (their plain "
                        'versions)')
    p.add_argument('--coco-json', type=str, default=None,
                   help='Also write detections as a standard COCO results '
                        'JSON (image_id from numeric filename stems, else '
                        'the 0-based input index)')
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> int:
    logging.basicConfig(level=logging.INFO)
    args = parse_args(argv)

    from yoloclip_tpu_torch.config import InferenceConfig, load_config
    from yoloclip_tpu_torch.inference.detector import YOLOCLIPDetector

    cfg = load_config(InferenceConfig, args.config)
    overrides = {}
    if args.model:
        overrides['model_path'] = args.model
    if args.vocab:
        overrides['vocab_path'] = args.vocab
    if args.output:
        overrides['output_dir'] = args.output
    if args.conf is not None:
        overrides['conf_threshold'] = args.conf
    if args.iou is not None:
        overrides['iou_threshold'] = args.iou
    if args.classes:
        overrides['class_names'] = tuple(
            c.strip() for c in args.classes.split(','))
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    if args.backbone:
        cfg = dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model,
                                           backbone_variant=args.backbone))

    text_prompts = None
    if args.text_prompts:
        text_prompts = [t.strip() for t in args.text_prompts.split(',')]
        cfg = dataclasses.replace(cfg, use_offline_vocab=False)

    detector = YOLOCLIPDetector(
        cfg, vocab_path=cfg.vocab_path, model_path=cfg.model_path,
        text_checkpoint=args.text_checkpoint, device=args.device)

    if os.path.isdir(args.input):
        exts = ('.jpg', '.jpeg', '.png', '.bmp')
        paths = sorted(os.path.join(args.input, f)
                       for f in os.listdir(args.input)
                       if f.lower().endswith(exts))
    else:
        paths = [args.input]

    if args.int8:
        if not paths:
            logger.warning('--int8: no input images found, nothing to do')
            return 1
        import numpy as np

        from yoloclip_tpu_torch.data.coco import _imread_rgb
        # inputs may differ in size: letterbox each to the model canvas
        calib = np.stack([detector._host_letterbox(_imread_rgb(p))[0]
                          for p in paths[:8]])
        detector.quantize_int8(calib)

    os.makedirs(cfg.output_dir, exist_ok=True)
    coco_results = []
    for idx, path in enumerate(paths):
        dets = detector.detect(path, text_prompts=text_prompts)
        logger.info('%s: %d detections', path, len(dets))
        for d in dets:
            logger.info('  %s %.3f %s', d['class_name'], d['score'],
                        d['box'])
        if args.coco_json:
            from yoloclip_tpu_torch.utils.metrics import (
                detections_to_coco_results)
            stem = os.path.splitext(os.path.basename(path))[0]
            image_id = int(stem) if stem.isdigit() else idx
            coco_results.extend(detections_to_coco_results(dets, image_id))
        drawn = detector.draw_detections(path, dets)
        out_path = os.path.join(cfg.output_dir, os.path.basename(path))
        _imwrite_rgb(out_path, drawn)
        logger.info('saved %s', out_path)
    if args.coco_json:
        from yoloclip_tpu_torch.utils.metrics import save_coco_results
        save_coco_results(args.coco_json, coco_results)
        logger.info('wrote %d COCO results entries to %s',
                    len(coco_results), args.coco_json)
    return 0


def _imwrite_rgb(path: str, img) -> None:
    try:
        import cv2
        cv2.imwrite(path, cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
    except ImportError:
        from PIL import Image
        Image.fromarray(img).save(path)


if __name__ == '__main__':
    raise SystemExit(main())
