"""Demo CLI: offline (class list) vs online (free-text prompts) detection.
Counterpart of `yoloclip_tpu/cli/demo.py`: one image, either a class-name
vocabulary or raw prompts, optional matplotlib display, drawn output saved
to disk.

    python -m yoloclip_tpu_torch.cli.demo --image img.jpg --classes cat,dog
    python -m yoloclip_tpu_torch.cli.demo --image img.jpg \
        --prompts "a red car,a person" --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
from typing import List, Optional

logger = logging.getLogger('yoloclip_tpu_torch.demo')


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(description='YOLO-CLIP PyTorch demo')
    p.add_argument('--image', type=str, required=True)
    p.add_argument('--model', type=str, default=None,
                   help='detector weights: a torch .pt/.pth state dict')
    p.add_argument('--classes', type=str, default=None,
                   help='Offline mode: comma-separated class names')
    p.add_argument('--prompts', type=str, default=None,
                   help='Online mode: comma-separated free-text prompts')
    p.add_argument('--conf', type=float, default=0.25)
    p.add_argument('--output', type=str, default='demo_output.jpg')
    p.add_argument('--device', type=str, default='cuda',
                   help="'cuda' (the kernels) or 'cpu' (their plain "
                        'versions)')
    p.add_argument('--show', action='store_true',
                   help='Display with matplotlib')
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> int:
    logging.basicConfig(level=logging.INFO)
    args = parse_args(argv)

    from yoloclip_tpu_torch.config import InferenceConfig
    from yoloclip_tpu_torch.inference.detector import YOLOCLIPDetector

    cfg = dataclasses.replace(InferenceConfig(), conf_threshold=args.conf,
                              use_offline_vocab=args.prompts is None)
    class_names = ([c.strip() for c in args.classes.split(',')]
                   if args.classes else None)
    detector = YOLOCLIPDetector(cfg, class_names=class_names,
                                model_path=args.model, device=args.device)

    prompts = ([t.strip() for t in args.prompts.split(',')]
               if args.prompts else None)
    dets = detector.detect(args.image, text_prompts=prompts)
    logger.info('%d detections', len(dets))
    for d in dets:
        logger.info('  %s %.3f %s', d['class_name'], d['score'], d['box'])

    drawn = detector.draw_detections(args.image, dets)
    try:
        import cv2
        cv2.imwrite(args.output, cv2.cvtColor(drawn, cv2.COLOR_RGB2BGR))
    except ImportError:
        from PIL import Image
        Image.fromarray(drawn).save(args.output)
    logger.info('saved %s', args.output)

    if args.show:
        import matplotlib.pyplot as plt
        plt.imshow(drawn)
        plt.axis('off')
        plt.show()
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
