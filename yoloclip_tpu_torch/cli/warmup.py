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

    python -m yoloclip_tpu_torch.cli.warmup              # kernels + native
    python -m yoloclip_tpu_torch.cli.warmup --device cpu # native only

--int8 and --stem-u8-s2d are not ported yet (ROADMAP.md, queue A: int8
deploy) and raise NotImplementedError.
"""

from __future__ import annotations

import argparse
import logging
import time

logger = logging.getLogger('yoloclip_tpu_torch.warmup')


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument('--device', default='cuda', choices=['cuda', 'cpu'],
                    help="'cuda' builds the CUDA kernels and the native "
                         "library, 'cpu' the native library alone")
    ap.add_argument('--int8', action='store_true',
                    help='the W8A8 deploy graph (not ported yet)')
    ap.add_argument('--stem-u8-s2d', action='store_true',
                    help='the uint8 space-to-depth stem layout (not ported '
                         'yet)')
    args = ap.parse_args(argv)
    if args.int8 or args.stem_u8_s2d:
        raise NotImplementedError(
            '--int8 and --stem-u8-s2d are not ported yet (ROADMAP.md, '
            'queue A: int8 deploy)')
    logging.basicConfig(level=logging.INFO, format='%(message)s')

    from yoloclip_tpu_torch import _build, native
    names = ('similarity', 'nms') if args.device == 'cuda' else ()
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
    logger.info('warmup complete')
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
