"""The system under test, `yoloclip_tpu_torch`: the one module of the
benchmark that imports it. It builds the detector from a configuration
file's settings, reads the system's counters, and plants the faults that
the comparison's upper readings are read from; nothing else of the
system is used.
"""

from __future__ import annotations

import logging
from typing import Dict


def quiet() -> None:
    """Keep the system's per-batch warnings (a saturated NMS prefilter,
    a random-init text tower) off standard error: the run's last lines
    there are the comparison's numbers."""
    logging.getLogger('yoloclip_tpu_torch').setLevel(logging.ERROR)


def detector(cfg: Dict, state_dict, vocab_path: str, device):
    """A YOLOCLIPDetector with the configuration's model and inference
    settings, the seeded weights (reference layout) and the seeded
    offline vocabulary."""
    from yoloclip_tpu_torch.config import InferenceConfig, ModelConfig
    from yoloclip_tpu_torch.inference.detector import YOLOCLIPDetector
    model = ModelConfig(
        backbone_variant=cfg['backbone_variant'],
        clip_model=cfg['clip_model'], embed_dim=cfg['embed_dim'],
        reg_max=cfg['reg_max'], strides=tuple(cfg['strides']),
        hidden_dim=cfg['hidden_dim'],
        neck_bottlenecks=cfg['neck_bottlenecks'],
        cls_alpha=cfg['cls_alpha'], cls_beta=cfg['cls_beta'],
        image_size=tuple(cfg['image_size']), dtype=cfg['dtype'])
    inf = InferenceConfig(
        model=model, conf_threshold=cfg['conf_threshold'],
        iou_threshold=cfg['iou_threshold'], nms_topk=cfg['nms_topk'],
        max_detections=cfg['max_detections'],
        class_agnostic_nms=cfg['class_agnostic_nms'])
    return YOLOCLIPDetector(inf, vocab_path=vocab_path,
                            state_dict=state_dict, device=device, seed=0)


def counters() -> Dict[str, int]:
    """The hand kernels' launch counters ('module.counter' -> count)."""
    from yoloclip_tpu_torch.ops.kernels import read_counts
    return dict(read_counts())


def program_count(det) -> int:
    return det.programs.count()


def _nearest(x, rh: int, rw: int):
    """(B, h, w, C) -> (B, rh, rw, C) by nearest source pixel."""
    import torch
    B, h, w, C = x.shape
    if (rh, rw) == (h, w):
        return x
    ih = ((torch.arange(rh, device=x.device) + 0.5) * (h / rh)).long()
    iw = ((torch.arange(rw, device=x.device) + 0.5) * (w / rw)).long()
    return x[:, ih][:, :, iw]


def _broken_batch(kind: str):
    """The batch program's body with its answer corrupted after it is
    produced."""
    from yoloclip_tpu_torch.inference.detector import YOLOCLIPDetector
    real = YOLOCLIPDetector._detect_batch_eager
    last = {}

    def body(self, images, text):
        out = real(self, images, text)
        if kind == 'stale':
            prev = last.get('out')
            last['out'] = {k: v.clone() for k, v in out.items()}
            return prev if prev is not None else out
        B = out['count'].shape[0]
        if kind == 'half':
            out['count'][B // 2:] = 0
            out['valid'][B // 2:] = False
            out['scores'][B // 2:] = 0
        if kind == 'alter':
            out['boxes'][0] += 100
            out['class_ids'][0] = (out['class_ids'][0] + 1) % text.shape[0]
        return out
    return YOLOCLIPDetector, '_detect_batch_eager', body


def fault(kind: str):
    """(object, attribute, replacement) that breaks the batch path where
    its answer is produced: for the tests that see `correct` come out
    false, and for the readings that set the comparison's upper limits.

      stale    each call returns the previous call's answer;
      half     the second half of each batch's answers left out;
      alter    the first image's answer altered: every box moved by 100
               pixels on each coordinate, every class id one further;
      rescale  boxes left in the canvas's pixels (the divide by the
               letterbox's scale left out);
      resize   the letterbox's bilinear resize replaced by the nearest
               source pixel.

    The caller sets the attribute (and restores it)."""
    from yoloclip_tpu_torch.inference import detector
    from yoloclip_tpu_torch.ops import preprocess
    if kind in ('stale', 'half', 'alter'):
        return _broken_batch(kind)
    if kind == 'rescale':
        real = detector.rescale_boxes
        return (detector, 'rescale_boxes',
                lambda boxes, scale, hw: real(boxes, 1.0, hw))
    if kind == 'resize':
        return preprocess, '_resize', _nearest
    raise ValueError(f'unknown fault {kind!r}')
