"""HTTP detection service (stdlib-only) over the micro-batching runtime.
Counterpart of `yoloclip_tpu/cli/serve.py`.

    # serve COCO-80 in bf16 on :8000 (random weights unless --model):
    python -m yoloclip_tpu_torch.cli.serve --port 8000

    # on the CPU, small (the port's CPU drive):
    python -m yoloclip_tpu_torch.cli.serve --device cpu --image-size 128 \
        --classes cat,dog --conf -1 --port 18231

    # serve COCO-80 int8 (calibrated on a directory of images):
    python -m yoloclip_tpu_torch.cli.serve --int8 --calib-dir samples/

    # query it:
    curl -s -X POST --data-binary @dog.jpg localhost:8000/detect
    curl -s localhost:8000/stats

Endpoints:
    POST /detect   image bytes (JPEG/PNG) -> JSON detection list
                   (same schema as YOLOCLIPDetector.detect: box int xyxy
                   in ORIGINAL image pixels, score, class_id, class_name)
    POST /vocab    JSON {"class_names": [...]} -> hot-swap the serving
                   vocabulary (encoded once; the next batch scores against
                   it)
    GET  /stats    micro-batcher counters (occupancy, latency percentiles)
    GET  /healthz  liveness

Concurrent requests from `ThreadingHTTPServer`'s per-client threads block
on futures from ONE `DetectionServer` (`inference/server.py`), which
coalesces them into device batches.

--int8 serves the W8A8 deploy graph, its activation scales calibrated on
up to 16 images of --calib-dir; --stem-u8-s2d the uint8 space-to-depth
stem layout. --devices N|auto|LIST serves data-parallel: one replica of
the model a device, each batch split over them (`inference/server.py`,
`mesh=`); N takes cuda:0..N-1 (with --device cpu, N replicas on the CPU),
'auto' every card, and a comma-separated list names the devices, which
may repeat (cuda:0,cuda:0: two replicas on one card). It composes with
--int8 and bf16. --spatial M (with --devices) additionally splits each
frame's height M-way: the devices form an (N/M, M) ('data', 'model') mesh,
batches over N/M, each row's frames over its M devices
(`parallel/spatial.py`); M must divide N:

    python -m yoloclip_tpu_torch.cli.serve --devices cuda:0,cuda:0 \
        --spatial 2 --port 8000

An orbax checkpoint directory as --model is refused with
NotImplementedError, by design: the port reads torch files only; convert
the directory first on a machine with JAX (`tools/orbax_to_torch.py`).
"""

from __future__ import annotations

import argparse
import io
import json
import logging
import signal
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

logger = logging.getLogger('yoloclip_tpu_torch.serve')

MAX_BODY_BYTES = 64 * 1024 * 1024


def decode_image_bytes(buf: bytes) -> np.ndarray:
    """JPEG/PNG bytes -> (H, W, 3) uint8 RGB: the native C++ decoder
    first, PIL after it (also where the library has no codecs)."""
    from yoloclip_tpu_torch import native
    if native.codecs_available():
        try:
            return native.decode_bytes(buf)
        except ValueError:
            pass   # unusual format: fall through
    from PIL import Image
    return np.asarray(Image.open(io.BytesIO(buf)).convert('RGB'))


def make_handler(server):
    """Bind a BaseHTTPRequestHandler subclass to a DetectionServer."""

    class Handler(BaseHTTPRequestHandler):
        protocol_version = 'HTTP/1.1'

        def _reply(self, code: int, payload) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header('Content-Type', 'application/json')
            self.send_header('Content-Length', str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _read_body(self) -> Optional[bytes]:
            n = int(self.headers.get('Content-Length') or 0)
            if n <= 0:
                self._reply(400, {'error': 'empty body'})
                return None
            if n > MAX_BODY_BYTES:
                self._reply(413, {'error': 'body too large'})
                return None
            return self.rfile.read(n)

        def do_GET(self):
            if self.path == '/healthz':
                self._reply(200, {'status': 'ok'})
            elif self.path == '/stats':
                self._reply(200, server.stats())
            else:
                self._reply(404, {'error': f'unknown path {self.path}'})

        def do_POST(self):
            body = self._read_body()
            if body is None:
                return
            if self.path == '/detect':
                try:
                    image = decode_image_bytes(body)
                except Exception:
                    self._reply(400, {'error': 'undecodable image'})
                    return
                try:
                    dets = server.detect(image, timeout=60.0)
                except Exception as e:
                    self._reply(500, {'error': str(e)})
                    return
                self._reply(200, {'detections': dets})
            elif self.path == '/vocab':
                try:
                    names = json.loads(body)['class_names']
                except Exception:
                    names = None
                # explicit check, not assert: `python -O` strips asserts
                # and an empty vocabulary poisons every later batch (C=0)
                if not isinstance(names, list) or not names:
                    self._reply(
                        400, {'error': 'expected {"class_names": [...]}'})
                    return
                server.set_vocabulary([str(n) for n in names])
                self._reply(200, {'status': 'ok', 'classes': len(names)})
            else:
                self._reply(404, {'error': f'unknown path {self.path}'})

        def log_message(self, fmt, *args):   # route through logging
            logger.info('%s -- %s', self.address_string(), fmt % args)

    return Handler


def build_server(args):
    """args -> (DetectionServer, detector). Split out for tests."""
    mesh = None
    spatial = max(int(getattr(args, 'spatial', 1) or 1), 1)
    if args.devices:
        from yoloclip_tpu_torch.parallel.mesh import create_mesh
        devices = serve_devices(args.devices, args.device)
        n = len(devices)
        if n % spatial:
            raise SystemExit(f'--spatial {spatial} must divide the device '
                             f'count ({n})')
        if n > 1:
            mesh = create_mesh(n_data=n // spatial, n_model=spatial,
                               devices=devices)
            logger.info('serving over %s%s', mesh,
                        (' (height axis spatially partitioned '
                         f'{spatial}-way)') if spatial > 1 else '')
    elif spatial > 1:
        raise SystemExit('--spatial needs --devices')
    from yoloclip_tpu_torch.config import (COCO_CLASS_NAMES, InferenceConfig,
                                           ModelConfig)
    from yoloclip_tpu_torch.inference.detector import YOLOCLIPDetector
    from yoloclip_tpu_torch.inference.server import DetectionServer

    classes = ([c.strip() for c in args.classes.split(',') if c.strip()]
               if args.classes else list(COCO_CLASS_NAMES))
    cfg = InferenceConfig(
        model=ModelConfig(backbone_variant=args.variant,
                          image_size=(args.image_size, args.image_size),
                          dtype='bfloat16', stem_u8_s2d=args.stem_u8_s2d),
        class_names=tuple(classes),
        conf_threshold=args.conf, iou_threshold=args.iou)
    detector = YOLOCLIPDetector(cfg, vocab_path=args.vocab or None,
                                model_path=args.model,
                                text_checkpoint=args.text_checkpoint,
                                device=args.device)
    if args.int8:
        if not args.calib_dir:
            raise SystemExit('--int8 needs --calib-dir (a directory of '
                             'representative images for activation '
                             'calibration)')
        import os

        from yoloclip_tpu_torch.data.coco import _imread_rgb
        exts = ('.jpg', '.jpeg', '.png')
        paths = sorted(
            os.path.join(args.calib_dir, f)
            for f in os.listdir(args.calib_dir)
            if f.lower().endswith(exts))[:16]
        if not paths:
            raise SystemExit(f'no jpg/png files in {args.calib_dir}')
        detector.quantize_int8(np.stack(
            [detector._host_letterbox(_imread_rgb(p))[0] for p in paths]))
        logger.info('int8 deploy path calibrated on %d images', len(paths))
    return DetectionServer(detector, max_batch=args.max_batch,
                           max_delay_ms=args.max_delay_ms, mesh=mesh,
                           spatial=spatial > 1,
                           bucket_batches=not args.no_bucket), detector


def serve_devices(spec: str, device: str) -> list:
    """--devices -> the replicas' devices: 'auto' (every card, or the CPU
    once), a count N (cuda:0..N-1, or N times the CPU under --device cpu)
    or a comma-separated list of devices."""
    import torch

    from yoloclip_tpu_torch.parallel.mesh import default_devices
    cpu = device.split(':')[0] == 'cpu'
    if spec == 'auto':
        return [torch.device('cpu')] if cpu else default_devices()
    if ',' in spec or not spec.isdigit():
        return [torch.device(d.strip()) for d in spec.split(',')
                if d.strip()]
    n = int(spec)
    if cpu:
        return [torch.device('cpu')] * n
    have = torch.cuda.device_count()
    if n > have:
        raise SystemExit(f'--devices {n} needs {n} CUDA devices, this '
                         f'machine has {have} (list devices to put several '
                         f'replicas on one, e.g. cuda:0,cuda:0)')
    return [torch.device(f'cuda:{i}') for i in range(n)]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        description='HTTP detection service (micro-batching)')
    ap.add_argument('--model', default=None,
                    help='detector weights: a torch .pt/.pth state dict')
    ap.add_argument('--classes', default=None,
                    help='comma-separated class names (default COCO-80)')
    ap.add_argument('--vocab', default=None, help='offline vocabulary JSON')
    ap.add_argument('--text-checkpoint', default=None,
                    help='CLIP text-tower weights (.npz or .pt/.pth)')
    ap.add_argument('--variant', default='n')
    ap.add_argument('--image-size', type=int, default=640)
    ap.add_argument('--conf', type=float, default=0.25)
    ap.add_argument('--iou', type=float, default=0.45)
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (the kernels) or 'cpu' (their plain "
                         'versions)')
    ap.add_argument('--int8', action='store_true',
                    help='serve the W8A8 deploy configuration')
    ap.add_argument('--calib-dir', default=None,
                    help='directory of images for int8 calibration')
    ap.add_argument('--max-batch', type=int, default=32)
    ap.add_argument('--max-delay-ms', type=float, default=5.0)
    ap.add_argument('--stem-u8-s2d', action='store_true',
                    help='serve the uint8 space-to-depth stem layout (the '
                         'canvas program space-to-depths the uint8 canvas '
                         'on the card; /255 folded into the stem kernel)')
    ap.add_argument('--no-bucket', action='store_true',
                    help='always dispatch max_batch-shaped batches instead '
                         'of padding to the smallest power-of-two bucket')
    ap.add_argument('--devices', default=None,
                    help="split batches over N devices ('auto' = every "
                         "card), or over a comma-separated device list; "
                         'one model replica each')
    ap.add_argument('--spatial', type=int, default=1, metavar='M',
                    help="additionally split each frame's HEIGHT M-way "
                         'over the devices (halo rows exchanged between '
                         'them); M must divide --devices; batches then '
                         'split over devices/M')
    ap.add_argument('--host', default='127.0.0.1')
    ap.add_argument('--port', type=int, default=8000)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    server, detector = build_server(args)
    # capture every bucket's program before the first request, so no
    # live request pays a batch size's warm-up and capture
    seconds = server.warmup()
    server.reset_stats()
    logger.info('warmup: %s', ', '.join(f'bs={b} {s:.2f}s'
                                        for b, s in seconds.items()))
    logger.info('serving %d classes (%s, %s) on %s:%d',
                len(detector.class_names), args.variant,
                'int8' if args.int8 else 'bf16', args.host, args.port)

    httpd = ThreadingHTTPServer((args.host, args.port),
                                make_handler(server))
    signal.signal(signal.SIGTERM,
                  lambda *_: threading.Thread(target=httpd.shutdown,
                                              daemon=True).start())
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.close()   # drains queued requests before stopping
        logger.info('drained and stopped: %s', server.stats())
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
