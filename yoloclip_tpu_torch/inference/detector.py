"""Batched open-vocabulary detection. Counterpart of
`yoloclip_tpu/inference/detector.py` for the offline-vocabulary path.

device letterbox -> model (folded similarity kernel on CUDA) -> DFL decode
-> rescale and clip -> top-k prefilter + greedy NMS (NMS kernel on CUDA).
`detect_batch` returns the NMS dict on the device; `detect` returns the
reference's list of detection dicts after ONE device-to-host copy of the
packed `(max_det + 1, 6)` result.

Not ported yet, and refused with NotImplementedError rather than replaced
by something else: text prompts and vocabulary building (the text tower),
the host-letterbox canvas path, int8 and the space-to-depth stems.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from yoloclip_tpu.config import InferenceConfig
from yoloclip_tpu_torch.models.yolo_clip import build_model
from yoloclip_tpu_torch.ops.nms import batched_nms, nms_fixed
from yoloclip_tpu_torch.ops.preprocess import (letterbox, letterbox_batch,
                                               rescale_boxes)
from yoloclip_tpu_torch.text.vocab import load_offline_vocabulary

logger = logging.getLogger(__name__)

_TEXT_TOWER = ('text prompts and vocabulary building need the CLIP text '
               'tower, which is not ported yet (ROADMAP.md, queue A: text tower); '
               'pass vocab_path= with a JSON vocabulary')


def _pack_detections(out: Dict[str, torch.Tensor]) -> torch.Tensor:
    """NMS dict -> ONE ([B,] max_det + 1, 6) float32 tensor: row 0 holds
    [count, prefilter_saturated, 0, 0, 0, 0], each following row
    [x1, y1, x2, y2, score, class_id]. The slot layout of the JAX
    package's `_pack_detections`."""
    packed = torch.cat([out['boxes'].float(),
                        out['scores'][..., None].float(),
                        out['class_ids'][..., None].float()], dim=-1)
    head = torch.zeros(packed.shape[:-2] + (1, 6), dtype=torch.float32,
                       device=packed.device)
    head[..., 0, 0] = out['count'].float()
    head[..., 0, 1] = out['prefilter_saturated'].float()
    return torch.cat([head, packed], dim=-2)


def _unpack_detections(packed: np.ndarray, names: Sequence[str]
                       ) -> Tuple[List[Dict], bool]:
    """One image's host (max_det + 1, 6) rows -> (detection dicts,
    prefilter_saturated). Boxes are truncated to int, as in the JAX
    package."""
    saturated = bool(packed[0, 1] > 0)
    n = int(packed[0, 0])
    dets = []
    for i in range(1, 1 + n):
        cid = int(packed[i, 5])
        dets.append({
            'box': packed[i, :4].astype(int).tolist(),
            'score': float(packed[i, 4]),
            'class_id': cid,
            'class_name': names[cid] if 0 <= cid < len(names)
            else f'Class {cid}',
        })
    return dets, saturated


def _imread_rgb(path: str) -> np.ndarray:
    from PIL import Image
    with Image.open(path) as im:
        return np.asarray(im.convert('RGB'))


class YOLOCLIPDetector:
    def __init__(self, config: Optional[InferenceConfig] = None,
                 vocab_path: Optional[str] = None,
                 state_dict: Optional[dict] = None,
                 device: Union[str, torch.device] = 'cuda',
                 seed: int = 0):
        """config: the JAX package's InferenceConfig. vocab_path: a JSON
        vocabulary {class: [E floats]} (required: the text tower is not
        ported). state_dict: weights in the reference key layout (e.g.
        `utils.convert.state_dict_from_jax`); None = random init from
        `seed` (bring-up mode). device: where the model runs -- a CUDA
        device runs the kernels, the CPU their plain versions."""
        cfg = config or InferenceConfig()
        if vocab_path is None:
            raise NotImplementedError(_TEXT_TOWER)
        if cfg.host_preprocess is True:
            raise NotImplementedError(
                'the host-letterbox canvas path is not ported yet '
                '(ROADMAP.md, queue A: host-letterbox canvas path); use '
                'host_preprocess=False')
        self.config = cfg
        self.device = torch.device(device)
        self.image_size = tuple(cfg.model.image_size)
        self.conf_threshold = cfg.conf_threshold
        self.iou_threshold = cfg.iou_threshold
        if state_dict is None:
            logger.warning('No weights given: random-init weights '
                           '(shape/latency bring-up mode)')
        dtype = (torch.bfloat16 if cfg.model.dtype == 'bfloat16'
                 else torch.float32)
        self.model = build_model(cfg.model, state_dict, seed).to(
            device=self.device, dtype=dtype,
            memory_format=torch.channels_last)
        self.load_offline_vocabulary(vocab_path)

    def load_offline_vocabulary(self, path: str) -> None:
        vocab = load_offline_vocabulary(path)
        self.class_names = list(vocab.keys())
        self.offline_vocabulary = torch.from_numpy(
            np.stack([vocab[k] for k in self.class_names])).to(self.device)

    def _use_fused_similarity(self) -> bool:
        # as the JAX package keeps its Pallas kernel to the accelerator
        return (self.config.fused_similarity
                and self.device.type == 'cuda')

    def _nms_args(self) -> Dict:
        c = self.config
        return dict(conf_threshold=self.conf_threshold,
                    iou_threshold=self.iou_threshold, topk=c.nms_topk,
                    max_detections=c.max_detections,
                    class_agnostic=c.class_agnostic_nms)

    @torch.inference_mode()
    def detect_batch(self, images: Union[np.ndarray, torch.Tensor],
                     text_prompts: Optional[Sequence[str]] = None
                     ) -> Dict[str, torch.Tensor]:
        """Same-size frames (B, H, W, 3) uint8 -> the batched NMS dict
        (boxes (B, D, 4), scores, class_ids, valid, count,
        prefilter_saturated), left on the device."""
        if text_prompts is not None:
            raise NotImplementedError(_TEXT_TOWER)
        images = torch.as_tensor(images, device=self.device)
        h, w = images.shape[1], images.shape[2]
        canvases, scale = letterbox_batch(images, self.image_size)
        out = self.model(canvases, self.offline_vocabulary,
                         fused_scores=self._use_fused_similarity())
        boxes = rescale_boxes(out['boxes'], scale, (h, w))
        return batched_nms(boxes, out['scores'], out['class_ids'],
                           **self._nms_args())

    def detect(self, image: Union[str, np.ndarray],
               text_prompts: Optional[Sequence[str]] = None) -> List[Dict]:
        """One frame -> list of {box (int xyxy), score, class_id,
        class_name}, sorted by score."""
        if text_prompts is not None:
            raise NotImplementedError(_TEXT_TOWER)
        start = time.time()
        if isinstance(image, str):
            image = _imread_rgb(image)
        orig = np.asarray(image)
        with torch.inference_mode():
            canvas, scale = letterbox(torch.as_tensor(orig, device=self.device),
                                      self.image_size)
            out = self.model(canvas[None], self.offline_vocabulary,
                             fused_scores=self._use_fused_similarity())
            boxes = rescale_boxes(out['boxes'][0], scale, orig.shape[:2])
            packed = _pack_detections(nms_fixed(
                boxes, out['scores'][0], class_ids=out['class_ids'][0],
                **self._nms_args()))
        packed = packed.cpu().numpy()       # the ONE device -> host copy
        detections, saturated = _unpack_detections(packed, self.class_names)
        if saturated:
            logger.warning(
                'NMS prefilter saturated: more than nms_topk=%d candidates '
                'above conf %.3g -- detections may be clipped; raise '
                'config.nms_topk or the confidence threshold',
                self.config.nms_topk, float(self.conf_threshold))
        logger.info('Detection completed in %.3f seconds with %d objects',
                    time.time() - start, len(detections))
        return detections

    def draw_detections(self, image: Union[str, np.ndarray],
                        detections: List[Dict]) -> np.ndarray:
        from yoloclip_tpu.utils.visualize import draw_detections
        if isinstance(image, str):
            image = _imread_rgb(image)
        return draw_detections(image, detections, len(self.class_names) or 80)
