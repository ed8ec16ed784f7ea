"""Warmup for serving deployments. Counterpart of
`yoloclip_tpu/cli/warmup.py`.

What lasts between processes is the build: the nvcc kernels (`csrc/`) and
the g++ host library (`native/`) in `_kernels/`. This CLI builds each one
that is missing or older than its source, loads it and reports the time,
so that the first serving process only loads them. Eager PyTorch keeps no
compile cache, so unlike the JAX package there is no per-shape program to
fill. The per-shape first-call setup (lazy CUDA module loading, cuDNN)
lasts only in the process that pays it: `DetectionServer.warmup()` pays it
for every bucket inside the server, and `cli.serve` calls it and logs its
seconds before it takes traffic.

--int8 also checks the W8A8 deploy graph end to end on this machine, as the
JAX CLI's --int8 does: a detector at --image-size calibrates on 4 seeded
random frames (`quantize_int8`) and runs one `detect_batch`, both timed
(--stem-u8-s2d: in the uint8 space-to-depth stem layout).

    python -m yoloclip_tpu_torch.cli.warmup              # kernels + native
    python -m yoloclip_tpu_torch.cli.warmup --device cpu # native only
    python -m yoloclip_tpu_torch.cli.warmup --int8       # + the int8 graph
"""

from __future__ import annotations

import argparse
import logging
import time

import numpy as np

logger = logging.getLogger('yoloclip_tpu_torch.warmup')

CLASSES = ('person', 'car')     # the vocabulary --int8 calibrates against


def _int8_check(args) -> None:
    from yoloclip_tpu_torch.config import InferenceConfig, ModelConfig
    from yoloclip_tpu_torch.inference.detector import YOLOCLIPDetector
    S = args.image_size
    cfg = InferenceConfig(model=ModelConfig(image_size=(S, S),
                                            stem_u8_s2d=args.stem_u8_s2d))
    det = YOLOCLIPDetector(cfg, class_names=CLASSES, model_path=args.model,
                           text_checkpoint=args.text_checkpoint,
                           device=args.device)
    rs = np.random.RandomState(0)
    t0 = time.time()
    det.quantize_int8((rs.rand(4, S, S, 3) * 255).astype(np.uint8))
    logger.info('quantize_int8 calibration: %.1fs', time.time() - t0)
    t0 = time.time()
    out = det.detect_batch((rs.rand(2, S, S, 3) * 255).astype(np.uint8))
    count = out['count'].tolist()         # waits for the batch
    logger.info('int8 detect_batch bs=2 @%dpx: %.1fs, counts %s', S,
                time.time() - t0, count)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument('--device', default='cuda', choices=['cuda', 'cpu'],
                    help="'cuda' builds the CUDA kernels and the native "
                         "library, 'cpu' the native library alone")
    ap.add_argument('--int8', action='store_true',
                    help='also calibrate and run the W8A8 deploy graph')
    ap.add_argument('--stem-u8-s2d', action='store_true',
                    help='with --int8: the uint8 space-to-depth stem layout')
    ap.add_argument('--image-size', type=int, default=640)
    ap.add_argument('--model', default=None,
                    help='detector weights: a torch .pt/.pth state dict')
    ap.add_argument('--text-checkpoint', default=None)
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format='%(message)s')

    from yoloclip_tpu_torch import _build, native
    names = _build.KERNELS if args.device == 'cuda' else ()
    for name in names:
        t0 = time.time()
        _build.load(name)                # built if missing or stale
        logger.info('csrc/%s.cu built and loaded: %.1fs', name,
                    time.time() - t0)
    t0 = time.time()
    native.require()
    logger.info('native/dataload.cpp built and loaded (%s): %.1fs',
                'with codecs' if native.codecs_available() else
                'letterbox only', time.time() - t0)
    if args.int8:
        _int8_check(args)
    logger.info('warmup complete')
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
