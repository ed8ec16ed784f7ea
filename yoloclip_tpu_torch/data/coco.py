"""COCO detection dataset (a plain JSON parser, no pycocotools) and its
image helpers. The port's copy of `yoloclip_tpu/data/coco.py`: for a seed
it yields the same items, mosaic included, as the JAX package's.

  * Category-name -> class-index mapping restricted to the configured class
    list; only images with at least one mapped annotation are kept.
  * Per annotation: skip area <= 0 / empty bbox; xywh -> xyxy clamped to
    the image; skip degenerate boxes.
  * Letterbox: ratio = min(target/orig), int() resize dims, TOP-LEFT paste
    on a black canvas, boxes scaled by ratio.
  * Mosaic (train only, p=mosaic_prob): 4 letterboxed tiles squashed into
    quadrants around a random center in [t/4, 3t/4], boxes re-scaled by the
    quadrant ratio, clipped to [0, t-1], degenerate ones dropped; the draws
    come from one `random.Random(seed)`.
  * Targets padded (and truncated) to max_objects with a valid_mask.
  * text_prompts: "a photo of a {name}" per unique class present, with a
    class-0 fallback when empty.

Items are numpy, NHWC: images (H, W, 3) float32 [0, 1]; boxes
(max_objects, 4) xyxy letterboxed px; class_ids (max_objects,) int32;
valid_mask (max_objects,) bool; text_prompts list[str]; image_id int;
orig_size (h, w).
"""

from __future__ import annotations

import json
import os
import random
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


def _imread_rgb(path: str) -> np.ndarray:
    # native C++ decoder first (yoloclip_tpu_torch/native): byte-identical
    # to the JAX package's and thread-pool friendly; cv2 / PIL after it,
    # also where the library was built without codecs
    from yoloclip_tpu_torch import native
    if native.codecs_available():
        try:
            return native.decode_image(path)
        except ValueError:
            pass  # unusual format (bmp/tiff/...): fall through to cv2/PIL
    try:
        import cv2
        img = cv2.imread(path)
        if img is None:
            raise FileNotFoundError(path)
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    except ImportError:
        from PIL import Image
        return np.asarray(Image.open(path).convert('RGB'))


def _resize(img: np.ndarray, wh: Tuple[int, int]) -> np.ndarray:
    w, h = wh
    try:
        import cv2
        return cv2.resize(img, (w, h))
    except ImportError:
        pass
    try:
        from PIL import Image
        return np.asarray(Image.fromarray(img).resize((w, h)))
    except ImportError:
        return _resize_numpy_bilinear(img, w, h)


def _resize_numpy_bilinear(img: np.ndarray, w: int, h: int) -> np.ndarray:
    """Pure-numpy bilinear resize (half-pixel centers, cv2/PIL convention),
    the last resort on hosts with neither cv2 nor PIL. Within ~1 LSB of
    cv2's INTER_LINEAR away from borders."""
    ih, iw = img.shape[:2]
    x = (np.arange(w, dtype=np.float64) + 0.5) * (iw / w) - 0.5
    y = (np.arange(h, dtype=np.float64) + 0.5) * (ih / h) - 0.5
    x0 = np.clip(np.floor(x).astype(np.int64), 0, iw - 1)
    y0 = np.clip(np.floor(y).astype(np.int64), 0, ih - 1)
    x1 = np.minimum(x0 + 1, iw - 1)
    y1 = np.minimum(y0 + 1, ih - 1)
    fx = np.clip(x - x0, 0.0, 1.0)[None, :, None]
    fy = np.clip(y - y0, 0.0, 1.0)[:, None, None]
    im = img.astype(np.float64)
    top = im[y0[:, None], x0[None, :]] * (1 - fx) + im[y0[:, None],
                                                       x1[None, :]] * fx
    bot = im[y1[:, None], x0[None, :]] * (1 - fx) + im[y1[:, None],
                                                       x1[None, :]] * fx
    out = top * (1 - fy) + bot * fy
    if np.issubdtype(img.dtype, np.integer):
        return np.clip(np.rint(out), 0, 255).astype(img.dtype)
    return out.astype(img.dtype)


class CocoIndex:
    """Minimal COCO annotation index built from the raw JSON."""

    def __init__(self, anno_path: str):
        with open(anno_path) as f:
            data = json.load(f)
        self.images = {im['id']: im for im in data.get('images', [])}
        self.categories = {c['id']: c for c in data.get('categories', [])}
        self.anns_by_image: Dict[int, List[dict]] = {}
        for ann in data.get('annotations', []):
            self.anns_by_image.setdefault(ann['image_id'], []).append(ann)


class COCODataset:
    def __init__(self,
                 anno_path: str,
                 img_dir: str,
                 class_names: Sequence[str],
                 img_size: Tuple[int, int] = (640, 640),
                 transform: Optional[Callable] = None,
                 mode: str = 'train',
                 mosaic_prob: float = 0.5,
                 max_objects: int = 100,
                 seed: Optional[int] = None):
        self.img_dir = img_dir
        self.class_names = list(class_names)
        self.img_size = img_size
        self.transform = transform
        self.mode = mode
        self.mosaic_prob = mosaic_prob if mode == 'train' else 0.0
        self.max_objects = max_objects
        self.rng = random.Random(seed)

        index = CocoIndex(anno_path)
        name_to_class = {n: i for i, n in enumerate(self.class_names)}
        self.cat_id_to_class_id = {
            cid: name_to_class[c['name']]
            for cid, c in index.categories.items()
            if c['name'] in name_to_class
        }
        self.image_ids: List[int] = []
        self.image_infos: List[dict] = []
        for img_id, info in index.images.items():
            anns = index.anns_by_image.get(img_id, [])
            if any(a['category_id'] in self.cat_id_to_class_id for a in anns):
                self.image_ids.append(img_id)
                self.image_infos.append(info)
        self._index = index

    def __len__(self) -> int:
        return len(self.image_ids)

    # ------------------------------------------------------------------
    def _load_image_and_targets(self, idx: int
                                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        info = self.image_infos[idx]
        img = _imread_rgb(os.path.join(self.img_dir, info['file_name']))
        boxes, class_ids = [], []
        for ann in self._index.anns_by_image.get(self.image_ids[idx], []):
            if ann['category_id'] not in self.cat_id_to_class_id:
                continue
            if ann.get('area', 0) <= 0 or not ann.get('bbox'):
                continue
            x, y, w, h = ann['bbox']
            x1, y1 = max(0, x), max(0, y)
            x2 = min(info['width'], x + w)
            y2 = min(info['height'], y + h)
            if x2 <= x1 or y2 <= y1:
                continue
            boxes.append([x1, y1, x2, y2])
            class_ids.append(self.cat_id_to_class_id[ann['category_id']])
        return (img,
                np.asarray(boxes, np.float32).reshape(-1, 4),
                np.asarray(class_ids, np.int32))

    def _letterbox(self, img: np.ndarray, boxes: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray]:
        th, tw = self.img_size
        oh, ow = img.shape[:2]
        ratio = min(th / oh, tw / ow)
        nh, nw = int(oh * ratio), int(ow * ratio)
        canvas = np.zeros((th, tw, 3), np.uint8)
        canvas[:nh, :nw] = _resize(img, (nw, nh))
        if len(boxes):
            boxes = boxes * ratio
        return canvas, boxes

    def _pad_targets(self, boxes: np.ndarray, class_ids: np.ndarray):
        M = self.max_objects
        bp = np.zeros((M, 4), np.float32)
        cp = np.zeros((M,), np.int32)
        vp = np.zeros((M,), bool)
        n = min(len(boxes), M)
        if n:
            bp[:n] = boxes[:n]
            cp[:n] = class_ids[:n]
            vp[:n] = True
        return bp, cp, vp

    def _prompts_for(self, class_ids: np.ndarray) -> List[str]:
        prompts = [f'a photo of a {self.class_names[c]}'
                   for c in sorted(set(int(c) for c in class_ids))
                   if c < len(self.class_names)]
        return prompts or [f'a photo of a {self.class_names[0]}']

    # ------------------------------------------------------------------
    def __getitem__(self, index: int) -> Dict:
        if self.rng.random() < self.mosaic_prob:
            return self._mosaic_item(index)
        img, boxes, class_ids = self._load_image_and_targets(index)
        orig_size = img.shape[:2]
        img, boxes = self._letterbox(img, boxes)
        if self.transform is not None:
            img, boxes, class_ids = self.transform(img, boxes, class_ids)
        bp, cp, vp = self._pad_targets(boxes, class_ids)
        return {
            'images': img.astype(np.float32) / 255.0,
            'boxes': bp, 'class_ids': cp, 'valid_mask': vp,
            'text_prompts': self._prompts_for(class_ids),
            'image_id': self.image_ids[index],
            'orig_size': orig_size,
        }

    def _mosaic_item(self, index: int) -> Dict:
        th, tw = self.img_size
        mosaic = np.zeros((th, tw, 3), np.uint8)
        all_boxes, all_cls = [], []
        indices = [index] + [self.rng.randint(0, len(self) - 1)
                             for _ in range(3)]
        cx = tw // 2 + self.rng.randint(-tw // 4, tw // 4)
        cy = th // 2 + self.rng.randint(-th // 4, th // 4)
        quads = [(0, 0, cx, cy), (cx, 0, tw, cy),
                 (0, cy, cx, th), (cx, cy, tw, th)]
        for idx, (x1p, y1p, x2p, y2p) in zip(indices, quads):
            img, boxes, cls = self._load_image_and_targets(idx)
            img, boxes = self._letterbox(img, boxes)
            qw, qh = x2p - x1p, y2p - y1p
            if qw <= 0 or qh <= 0:
                continue
            mosaic[y1p:y2p, x1p:x2p] = _resize(img, (qw, qh))
            if len(boxes):
                boxes = boxes.copy()
                boxes[:, [0, 2]] = boxes[:, [0, 2]] * (qw / tw) + x1p
                boxes[:, [1, 3]] = boxes[:, [1, 3]] * (qh / th) + y1p
                boxes[:, [0, 2]] = np.clip(boxes[:, [0, 2]], 0, tw - 1)
                boxes[:, [1, 3]] = np.clip(boxes[:, [1, 3]], 0, th - 1)
                ok = (boxes[:, 2] > boxes[:, 0]) & (boxes[:, 3] > boxes[:, 1])
                if ok.any():
                    all_boxes.append(boxes[ok])
                    all_cls.append(cls[ok])
        if all_boxes:
            boxes = np.vstack(all_boxes)
            cls = np.concatenate(all_cls)
        else:
            boxes = np.zeros((0, 4), np.float32)
            cls = np.zeros((0,), np.int32)
        if self.transform is not None:
            mosaic, boxes, cls = self.transform(mosaic, boxes, cls)
        bp, cp, vp = self._pad_targets(boxes, cls)
        return {
            'images': mosaic.astype(np.float32) / 255.0,
            'boxes': bp, 'class_ids': cp, 'valid_mask': vp,
            'text_prompts': self._prompts_for(cls),
            'image_id': -1,
            'orig_size': self.img_size,
        }
