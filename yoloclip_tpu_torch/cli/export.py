"""Export CLI: detector weights -> a `torch.export` serving artifact.
Counterpart of `yoloclip_tpu/cli/export.py` (StableHLO there), with its
flags; --device picks where to trace ('cuda', the default: the artifact
runs the CUDA kernels; 'cpu': their plain versions) and --int8 exports the
W8A8 deploy graph, calibrated as `cli.warmup --int8` calibrates (4 seeded
random frames).

    python -m yoloclip_tpu_torch.cli.export --model final_model.pt \
        --classes person,car --batch-size 32 --output model.pt2

--model takes the port's checkpoints, a torch state dict, a reference
trainer `.pth` (`utils/convert.py::load_reference_checkpoint`), or the
file `tools/orbax_to_torch.py` writes from a JAX orbax directory. Load the
artifact with `yoloclip_tpu_torch.utils.export.load_exported`.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import time
from typing import List, Optional

logger = logging.getLogger('yoloclip_tpu_torch.export')


def parse_args(argv: Optional[List[str]] = None):
    ap = argparse.ArgumentParser(
        description='Export YOLO-CLIP to a torch.export artifact')
    ap.add_argument('--config', default=None, help='YAML config file '
                    '(architecture must match the checkpoint)')
    ap.add_argument('--backbone', default=None, help='variant n/s/m/l/x')
    ap.add_argument('--model', default=None,
                    help='detector weights: a torch .pt/.pth (the port\'s '
                         'checkpoint, a state dict, a reference trainer '
                         'checkpoint, or tools/orbax_to_torch.py output)')
    ap.add_argument('--classes', required=True,
                    help='comma-separated class names (baked-in vocabulary)')
    ap.add_argument('--output', default='yolo_clip.pt2')
    ap.add_argument('--batch-size', type=int, default=32)
    ap.add_argument('--conf', type=float, default=0.25)
    ap.add_argument('--iou', type=float, default=0.45)
    ap.add_argument('--max-detections', type=int, default=300)
    ap.add_argument('--no-nms', action='store_true',
                    help='export raw boxes/scores (no suppression)')
    ap.add_argument('--skip-ipool', '--reparam', dest='skip_ipool',
                    action='store_true',
                    help='ALSO drop I-Pooling from the exported graph. '
                         'Only for models TRAINED without I-Pooling: on '
                         'I-Pool-trained weights this zeroes detection '
                         'quality (ops/reparam.py).')
    ap.add_argument('--platforms', default=None,
                    help="comma list of 'cuda' and/or 'cpu': where the "
                         'artifact will run (each artifact runs on both; '
                         'load_exported(path, device) moves it)')
    ap.add_argument('--text-checkpoint', default=None)
    ap.add_argument('--device', default='cuda', choices=['cuda', 'cpu'],
                    help="where to trace: 'cuda' (the kernels) or 'cpu' "
                         '(their plain versions)')
    ap.add_argument('--int8', action='store_true',
                    help='export the W8A8 deploy graph (calibrated on 4 '
                         'seeded random frames)')
    args = ap.parse_args(argv)
    platforms = ([p.strip() for p in args.platforms.split(',') if p.strip()]
                 if args.platforms else [])
    bad = [p for p in platforms if p not in ('cuda', 'cpu')]
    if bad:
        ap.error(f'--platforms {",".join(bad)}: the port exports for cuda '
                 'and cpu (a tpu artifact is the JAX package\'s '
                 'yoloclip_tpu.cli.export)')
    args.platforms = platforms
    return args


def main(argv: Optional[List[str]] = None) -> int:
    logging.basicConfig(level=logging.INFO)
    args = parse_args(argv)

    import numpy as np

    from yoloclip_tpu_torch.config import InferenceConfig, load_config
    from yoloclip_tpu_torch.inference.detector import YOLOCLIPDetector
    from yoloclip_tpu_torch.utils.export import export_detector

    cfg = load_config(InferenceConfig, args.config)
    if args.backbone:
        cfg = dataclasses.replace(
            cfg, model=dataclasses.replace(
                cfg.model, backbone_variant=args.backbone))
    class_names = [c.strip() for c in args.classes.split(',') if c.strip()]
    det = YOLOCLIPDetector(cfg, class_names=class_names,
                           model_path=args.model,
                           text_checkpoint=args.text_checkpoint,
                           device=args.device)
    h, w = det.image_size
    if args.int8:
        t0 = time.time()
        calib = np.random.RandomState(0).rand(4, h, w, 3) * 255
        det.quantize_int8(calib.astype(np.uint8))
        logger.info('quantize_int8 calibration: %.1fs', time.time() - t0)
    t0 = time.time()
    path = export_detector(
        det.model, det.offline_vocabulary, (args.batch_size, h, w),
        args.output, include_nms=not args.no_nms,
        conf_threshold=args.conf, iou_threshold=args.iou,
        nms_topk=cfg.nms_topk, max_detections=args.max_detections,
        skip_image_pool=args.skip_ipool, platforms=args.platforms)
    logger.info('exported %d-class %sdetector (bs=%d, %dx%d) on %s in '
                '%.1fs -> %s', len(class_names), 'int8 ' if args.int8 else '',
                args.batch_size, h, w, args.device, time.time() - t0, path)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
