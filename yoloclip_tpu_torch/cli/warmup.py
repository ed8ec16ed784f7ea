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
JAX CLI's --int8 does: the detector calibrates on 4 seeded random frames
(`quantize_int8`) against the --classes vocabulary, timed (--stem-u8-s2d:
in the uint8 space-to-depth stem layout).

The JAX CLI's flags run as they do there, each call timed and logged:
--batch-sizes runs one `detect_batch` for each size, --frame-sizes one
`detect()` for each HxW frame, with --conf and --host-preprocess in the
detector's config. Here they fill no cache: they pay this process's
first-call set-up and show that the path runs on this machine.

    python -m yoloclip_tpu_torch.cli.warmup              # kernels + native
    python -m yoloclip_tpu_torch.cli.warmup --device cpu # native only
    python -m yoloclip_tpu_torch.cli.warmup --classes person,car \
        --batch-sizes 1,8,32 --int8                      # + the int8 graph
"""

from __future__ import annotations

import argparse
import logging
import time

import numpy as np

logger = logging.getLogger('yoloclip_tpu_torch.warmup')

def _drive(args) -> None:
    """The detector at --image-size: --int8's calibration, then one timed
    detect_batch for each --batch-sizes and one detect() for each
    --frame-sizes."""
    from yoloclip_tpu_torch.config import InferenceConfig, ModelConfig
    from yoloclip_tpu_torch.inference.detector import YOLOCLIPDetector
    S = args.image_size
    hp = {'auto': 'auto', 'on': True, 'off': False}[args.host_preprocess]
    cfg = InferenceConfig(model=ModelConfig(image_size=(S, S),
                                            stem_u8_s2d=args.stem_u8_s2d),
                          conf_threshold=args.conf, host_preprocess=hp)
    class_names = [c.strip() for c in args.classes.split(',') if c.strip()]
    det = YOLOCLIPDetector(cfg, class_names=class_names,
                           model_path=args.model,
                           text_checkpoint=args.text_checkpoint,
                           device=args.device)
    rs = np.random.RandomState(0)
    if args.int8:
        t0 = time.time()
        det.quantize_int8((rs.rand(4, S, S, 3) * 255).astype(np.uint8))
        logger.info('quantize_int8 calibration: %.1fs', time.time() - t0)
    for bs in (int(b) for b in args.batch_sizes.split(',') if b):
        frames = (rs.rand(bs, S, S, 3) * 255).astype(np.uint8)
        t0 = time.time()
        count = det.detect_batch(frames)['count'].tolist()   # waits
        logger.info('%sdetect_batch bs=%d @%dpx: %.1fs, counts %s',
                    'int8 ' if args.int8 else '', bs, S, time.time() - t0,
                    count)
    for hw in (s for s in args.frame_sizes.split(',') if s):
        h, w = (int(x) for x in hw.split('x'))
        frame = (rs.rand(h, w, 3) * 255).astype(np.uint8)
        t0 = time.time()
        n = len(det.detect(frame))
        logger.info('detect() %dx%d: %.1fs, %d detections', h, w,
                    time.time() - t0, n)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument('--device', default='cuda', choices=['cuda', 'cpu'],
                    help="'cuda' builds the CUDA kernels and the native "
                         "library, 'cpu' the native library alone")
    ap.add_argument('--classes', default='person,car',
                    help='comma-separated vocabulary of the detector')
    ap.add_argument('--batch-sizes', default='1,32',
                    help='comma-separated detect_batch sizes to run')
    ap.add_argument('--frame-sizes', default='',
                    help='comma-separated HxW single-image detect() input '
                         'resolutions to run (e.g. 1080x1920,480x854)')
    ap.add_argument('--host-preprocess', default='auto',
                    choices=['auto', 'on', 'off'],
                    help="detect()'s preprocessing route: 'auto'/'on' the "
                         "host letterbox + canvas program, 'off' the device "
                         'letterbox')
    ap.add_argument('--conf', type=float, default=0.25)
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
    _drive(args)
    logger.info('warmup complete')
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
