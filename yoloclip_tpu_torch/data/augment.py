"""Numpy data augmentations (box-aware). The port's copy of
`yoloclip_tpu/data/augment.py`: the same draws from the same `random.Random`
give the same images and boxes.

The training recipe: HorizontalFlip p=0.5, ColorJitter(0.2/0.2/0.2/0.2)
p=0.5, RandomResizedCrop(size=img, scale 0.8-1.0) p=0.2. All transforms
operate on uint8 HWC + xyxy boxes.
"""

from __future__ import annotations

import random
from typing import Optional, Sequence, Tuple

import numpy as np

Boxes = np.ndarray


class Compose:
    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, img, boxes, class_ids):
        for t in self.transforms:
            img, boxes, class_ids = t(img, boxes, class_ids)
        return img, boxes, class_ids


class HorizontalFlip:
    def __init__(self, p: float = 0.5, rng: Optional[random.Random] = None):
        self.p = p
        self.rng = rng or random

    def __call__(self, img, boxes, class_ids):
        if self.rng.random() < self.p:
            w = img.shape[1]
            img = img[:, ::-1].copy()
            if len(boxes):
                boxes = boxes.copy()
                boxes[:, [0, 2]] = w - boxes[:, [2, 0]]
        return img, boxes, class_ids


class ColorJitter:
    """Brightness/contrast/saturation/hue jitter on uint8 RGB."""

    def __init__(self, brightness=0.2, contrast=0.2, saturation=0.2,
                 hue=0.2, p=0.5, rng: Optional[random.Random] = None):
        self.b, self.c, self.s, self.h = brightness, contrast, saturation, hue
        self.p = p
        self.rng = rng or random

    def __call__(self, img, boxes, class_ids):
        if self.rng.random() >= self.p:
            return img, boxes, class_ids
        r = self.rng
        x = img.astype(np.float32)
        x = x * (1 + r.uniform(-self.b, self.b))                 # brightness
        mean = x.mean()
        x = (x - mean) * (1 + r.uniform(-self.c, self.c)) + mean  # contrast
        gray = x.mean(axis=2, keepdims=True)
        x = (x - gray) * (1 + r.uniform(-self.s, self.s)) + gray  # saturation
        if self.h > 0:                                            # hue roll
            shift = r.uniform(-self.h, self.h)
            x = x + shift * 255.0 * np.array([1.0, -0.5, -0.5])
        return np.clip(x, 0, 255).astype(np.uint8), boxes, class_ids


class RandomResizedCrop:
    """Crop a random scale-window and resize back to the full size."""

    def __init__(self, size: Tuple[int, int], scale=(0.8, 1.0), p=0.2,
                 rng: Optional[random.Random] = None):
        self.size = size
        self.scale = scale
        self.p = p
        self.rng = rng or random

    def __call__(self, img, boxes, class_ids):
        if self.rng.random() >= self.p:
            return img, boxes, class_ids
        h, w = img.shape[:2]
        s = self.rng.uniform(*self.scale)
        ch, cw = int(h * s), int(w * s)
        y0 = self.rng.randint(0, h - ch) if h > ch else 0
        x0 = self.rng.randint(0, w - cw) if w > cw else 0
        crop = img[y0:y0 + ch, x0:x0 + cw]
        try:
            import cv2
            out = cv2.resize(crop, (self.size[1], self.size[0]))
        except ImportError:
            from PIL import Image
            out = np.asarray(Image.fromarray(crop).resize(
                (self.size[1], self.size[0])))
        if len(boxes):
            boxes = boxes.copy()
            sx = self.size[1] / cw
            sy = self.size[0] / ch
            boxes[:, [0, 2]] = np.clip((boxes[:, [0, 2]] - x0) * sx,
                                       0, self.size[1])
            boxes[:, [1, 3]] = np.clip((boxes[:, [1, 3]] - y0) * sy,
                                       0, self.size[0])
            ok = ((boxes[:, 2] - boxes[:, 0] > 1)
                  & (boxes[:, 3] - boxes[:, 1] > 1))
            boxes = boxes[ok]
            class_ids = class_ids[ok]
        return out, boxes, class_ids


def default_train_transforms(img_size: Tuple[int, int] = (640, 640),
                             seed: Optional[int] = None) -> Compose:
    """The training recipe (module docstring)."""
    rng = random.Random(seed)
    return Compose([
        HorizontalFlip(0.5, rng),
        ColorJitter(0.2, 0.2, 0.2, 0.2, 0.5, rng),
        RandomResizedCrop(img_size, (0.8, 1.0), 0.2, rng),
    ])
