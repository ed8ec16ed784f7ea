"""Multi-stream real-time detection CLI. Counterpart of
`yoloclip_tpu/cli/stream.py`.

    # N synthetic 1080p streams on the card, report fps:
    python -m yoloclip_tpu_torch.cli.stream --streams 8 --steps 50 \
        --classes person,car

    # real video files (one per stream, cv2 required):
    python -m yoloclip_tpu_torch.cli.stream --videos a.mp4,b.mp4

    # directory of jpg/png frames, decoded per step (pays real host
    # acquisition, unlike the synthetic source):
    python -m yoloclip_tpu_torch.cli.stream --images frames/ --streams 4

    # on the CPU:
    python -m yoloclip_tpu_torch.cli.stream --device cpu --streams 2 \
        --steps 2 --frame-size 96x160 --conf -1

This fronts `inference/streaming.py`: one batch per step over all streams
(device letterbox -> forward -> batched NMS), frame acquisition
double-buffered against device work. --int8 serves the W8A8 deploy graph,
calibrated on the first frame batch of the sources (a video or image
directory source advances past it).
"""

from __future__ import annotations

import argparse
import logging
import os
from typing import List, Optional

import numpy as np

logger = logging.getLogger('yoloclip_tpu_torch.stream')


def _synthetic_source(n_streams: int, hw):
    rng = np.random.RandomState(0)
    frame = (rng.rand(n_streams, hw[0], hw[1], 3) * 255).astype(np.uint8)

    def source(step: int) -> Optional[np.ndarray]:
        # cheap per-step variation without re-randomizing 50 MB
        return np.roll(frame, step, axis=2)
    return source


def _image_dir_source(directory: str, n_streams: int, hw):
    """Stream JPEG/PNG files round-robin: host decode and host letterbox
    to the frame size are PAID per step (unlike the synthetic source).
    The native library decodes where it has codecs and letterboxes where
    it is built; cv2/PIL otherwise."""
    from yoloclip_tpu_torch import native
    from yoloclip_tpu_torch.data.coco import _imread_rgb, _resize
    exts = ('.jpg', '.jpeg', '.png')
    paths = sorted(os.path.join(directory, f) for f in os.listdir(directory)
                   if f.lower().endswith(exts))
    if not paths:
        raise FileNotFoundError(f'no jpg/png files in {directory}')

    def _py_letterbox(img):
        h, w = img.shape[:2]
        s = min(hw[0] / h, hw[1] / w)
        rh, rw = max(int(h * s), 1), max(int(w * s), 1)
        canvas = np.zeros(hw + (3,), np.uint8)
        canvas[:rh, :rw] = _resize(img, (rw, rh))
        return canvas

    def decode(path: str) -> np.ndarray:
        img = (native.decode_image(path) if native.codecs_available()
               else _imread_rgb(path))
        if img.shape[:2] != hw:
            return (native.letterbox_u8(img, hw)[0] if native.available()
                    else _py_letterbox(img))
        return img

    def source(step: int) -> Optional[np.ndarray]:
        idx = [(step * n_streams + i) % len(paths)
               for i in range(n_streams)]
        return np.stack([decode(paths[j]) for j in idx])
    return source


def _video_source(paths: List[str], hw):
    import cv2
    caps = [cv2.VideoCapture(p) for p in paths]
    try:
        for p, c in zip(paths, caps):
            if not c.isOpened():
                raise FileNotFoundError(p)
    except Exception:
        for c in caps:
            c.release()
        raise

    def source(step: int) -> Optional[np.ndarray]:
        frames = []
        for c in caps:
            ok, f = c.read()
            if not ok:
                return None
            f = cv2.cvtColor(f, cv2.COLOR_BGR2RGB)
            if f.shape[:2] != hw:
                f = cv2.resize(f, (hw[1], hw[0]))
            frames.append(f)
        return np.stack(frames)

    def close():
        for c in caps:
            c.release()
    source.close = close
    return source


def main(argv: Optional[List[str]] = None) -> int:
    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser(description='YOLO-CLIP multi-stream demo')
    ap.add_argument('--streams', type=int, default=8)
    ap.add_argument('--steps', type=int, default=50)
    ap.add_argument('--frame-size', default='1080x1920',
                    help='HxW of the incoming frames')
    ap.add_argument('--classes', default='person,car')
    ap.add_argument('--videos', default=None,
                    help='comma-separated video files (overrides --streams)')
    ap.add_argument('--images', default=None,
                    help='directory of jpg/png frames streamed round-robin '
                         '(real host decode)')
    ap.add_argument('--model', default=None,
                    help='detector weights: a torch .pt/.pth state dict')
    ap.add_argument('--conf', type=float, default=0.25)
    ap.add_argument('--text-checkpoint', default=None)
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (the kernels) or 'cpu' (their plain "
                         'versions)')
    ap.add_argument('--int8', action='store_true',
                    help='serve the W8A8 selective-int8 deploy graph '
                         '(calibrated on the first frames of each stream)')
    args = ap.parse_args(argv)

    from yoloclip_tpu_torch.config import InferenceConfig
    from yoloclip_tpu_torch.inference.detector import YOLOCLIPDetector
    from yoloclip_tpu_torch.inference.streaming import StreamingDetector

    h, w = (int(x) for x in args.frame_size.split('x'))
    class_names = [c.strip() for c in args.classes.split(',') if c.strip()]
    cfg = InferenceConfig(conf_threshold=args.conf)

    # the detector owns the weights and the vocabulary
    det = YOLOCLIPDetector(cfg, class_names=class_names,
                           model_path=args.model,
                           text_checkpoint=args.text_checkpoint,
                           device=args.device)

    if args.videos:
        paths = args.videos.split(',')
        n_streams = len(paths)
        source = _video_source(paths, (h, w))
    elif args.images:
        n_streams = args.streams
        source = _image_dir_source(args.images, n_streams, (h, w))
    else:
        n_streams = args.streams
        source = _synthetic_source(n_streams, (h, w))

    if args.int8:
        first = source(0)
        if first is None:
            raise SystemExit('--int8 calibration failed: the frame source '
                             'produced no frames (empty/corrupt input?)')
        det.quantize_int8(first)      # keeps det.config.model in step
    sd = StreamingDetector(det.model, det.offline_vocabulary, n_streams,
                           frame_hw=(h, w), config=det.config,
                           device=args.device)
    counts = []

    def on_result(step, out):
        counts.append(int(np.sum(out['count'])))

    try:
        stats = sd.run(source, on_result, max_steps=args.steps)
    finally:
        if hasattr(source, 'close'):
            source.close()
    logger.info('%d streams x %d steps: %.1f ms/step, %.1f fps/stream, '
                'mean detections/step %.1f',
                n_streams, stats['steps'], stats['mean_step_ms'],
                stats['fps_per_stream'],
                float(np.mean(counts)) if counts else 0.0)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
