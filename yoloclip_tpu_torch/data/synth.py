"""Deterministic synthetic detection sets (multi-class, multi-object,
occlusions). The port's numpy-only copy of `yoloclip_tpu/data/synth.py`:
for a seed it draws the same arrays bit for bit.

6 classes = {square, circle, triangle} x 2 color families, 2-5 objects per
image with partial occlusion over a noisy background; class text embeddings
are fixed random unit vectors. The open-vocabulary family links each
class's draw color and its embedding through one latent direction.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

SYNTH_CLASS_NAMES = ('red square', 'green circle', 'blue triangle',
                     'yellow square', 'magenta circle', 'cyan triangle')

_PALETTE = np.array([
    [0.85, 0.15, 0.15],   # red
    [0.15, 0.80, 0.20],   # green
    [0.15, 0.25, 0.90],   # blue
    [0.90, 0.85, 0.15],   # yellow
    [0.85, 0.20, 0.85],   # magenta
    [0.15, 0.85, 0.85],   # cyan
], np.float32)

_SHAPES = ('square', 'circle', 'triangle', 'square', 'circle', 'triangle')


def _wheel_color(cls: int, num_classes: int) -> np.ndarray:
    """Distinct class color for >6-class sets: evenly spaced hues with
    alternating brightness. (<=6 classes keep the original _PALETTE so
    existing seeded datasets stay bit-identical.)"""
    import colorsys
    h = (cls / num_classes) % 1.0
    v = 0.85 if cls % 2 == 0 else 0.55
    return np.array(colorsys.hsv_to_rgb(h, 0.9, v), np.float32)


def _draw(img: np.ndarray, cls: int, x0: int, y0: int, w: int, h: int,
          rs: np.random.RandomState) -> None:
    color = np.clip(_PALETTE[cls] + rs.uniform(-0.08, 0.08, 3), 0, 1)
    shape = _SHAPES[cls]
    H, W = img.shape[:2]
    yy, xx = np.mgrid[0:H, 0:W]
    if shape == 'square':
        mask = (xx >= x0) & (xx < x0 + w) & (yy >= y0) & (yy < y0 + h)
    elif shape == 'circle':
        cx, cy = x0 + w / 2.0, y0 + h / 2.0
        mask = (((xx - cx) / (w / 2.0)) ** 2
                + ((yy - cy) / (h / 2.0)) ** 2) <= 1.0
    else:   # upright triangle: apex top-center, base at bottom
        ty = (yy - y0) / max(h - 1, 1)
        half = np.clip(ty, 0, 1) * (w / 2.0)
        cx = x0 + w / 2.0
        mask = (yy >= y0) & (yy < y0 + h) & (np.abs(xx - cx) <= half)
    img[mask] = color.astype(np.float32)


def make_synth_detection_set(n_images: int,
                             seed: int,
                             image_size: int = 160,
                             max_objects: int = 8,
                             num_classes: int = 6,
                             min_side: int = 24,
                             max_side: int = 64,
                             objects: Tuple[int, int] = (2, 5),
                             ) -> Dict[str, np.ndarray]:
    """Returns {'images' (N,S,S,3) float [0,1], 'boxes' (N,M,4) xyxy px,
    'class_ids' (N,M) int32, 'valid_mask' (N,M) bool}. Deterministic in
    (n_images, seed, geometry args). `objects=(lo, hi)` bounds the drawn
    object count per image (default (2, 5) keeps all previously seeded
    sets bit-identical); occlusion retries can drop below lo."""
    rs = np.random.RandomState(seed)
    S, M = image_size, max_objects
    images = np.empty((n_images, S, S, 3), np.float32)
    boxes = np.zeros((n_images, M, 4), np.float32)
    cids = np.zeros((n_images, M), np.int32)
    valid = np.zeros((n_images, M), bool)

    for i in range(n_images):
        img = np.clip(0.25 + 0.06 * rs.randn(S, S, 3), 0, 1
                      ).astype(np.float32)
        n_obj = rs.randint(objects[0], objects[1] + 1)
        placed = []
        for _ in range(n_obj):
            for _attempt in range(20):
                w = rs.randint(min_side, max_side + 1)
                h = rs.randint(min_side, max_side + 1)
                x0 = rs.randint(0, S - w)
                y0 = rs.randint(0, S - h)
                box = np.array([x0, y0, x0 + w, y0 + h], np.float32)
                # allow partial occlusion but cap IoU so GT stays sane
                ok = True
                for pb in placed:
                    ix = max(0, min(box[2], pb[0][2]) - max(box[0], pb[0][0]))
                    iy = max(0, min(box[3], pb[0][3]) - max(box[1], pb[0][1]))
                    inter = ix * iy
                    union = (w * h + (pb[0][2] - pb[0][0])
                             * (pb[0][3] - pb[0][1]) - inter)
                    if inter / union > 0.35:
                        ok = False
                        break
                if ok:
                    break
            else:
                continue
            cls = rs.randint(0, num_classes)
            if num_classes <= 6:    # original palette: keeps existing
                # seeded datasets bit-identical (cached trained states)
                _draw(img, cls, x0, y0, w, h, rs)
            else:
                _draw_colored(img, _wheel_color(cls, num_classes),
                              _SHAPES[cls % 3], x0, y0, w, h, rs)
            placed.append((box, cls))
        images[i] = img
        for j, (box, cls) in enumerate(placed[:M]):
            boxes[i, j] = box
            cids[i, j] = cls
            valid[i, j] = True
    return {'images': images, 'boxes': boxes, 'class_ids': cids,
            'valid_mask': valid}


def synth_text_embeddings(num_classes: int = 6, embed_dim: int = 512,
                          seed: int = 7) -> np.ndarray:
    """Fixed random unit-norm class embeddings (the offline 'vocabulary')."""
    rs = np.random.RandomState(seed)
    t = rs.randn(num_classes, embed_dim).astype(np.float32)
    return t / np.linalg.norm(t, axis=-1, keepdims=True)


# ---------------------------------------------------------------------
# open-vocabulary family: appearance IS a function of the embedding
# ---------------------------------------------------------------------
def _fibonacci_sphere(n: int) -> np.ndarray:
    """n well-separated unit directions on S^2 (deterministic)."""
    i = np.arange(n, dtype=np.float64) + 0.5
    phi = np.arccos(1 - 2 * i / n)
    theta = np.pi * (1 + 5 ** 0.5) * i
    return np.stack([np.sin(phi) * np.cos(theta),
                     np.sin(phi) * np.sin(theta),
                     np.cos(phi)], axis=1).astype(np.float32)


def make_open_vocab_family(n_classes: int, embed_dim: int = 512,
                           seed: int = 11) -> Dict[str, np.ndarray]:
    """Class family where APPEARANCE is a deterministic function of the
    class EMBEDDING -- the setup that makes held-out-class (zero-shot)
    detection measurable offline: detect classes named only at inference
    time.

    Construction: class c gets a unit direction u_c on the Fibonacci
    sphere (well-separated, deterministic); its draw color is
    0.5 + 0.35*u_c and its text embedding is normalize(B @ u_c) for a
    fixed orthonormal B (embed_dim x 3). Color and embedding are thus
    linked through the SAME latent: a detector that learns the
    color -> embedding map on training classes scores held-out classes
    correctly from their embeddings alone. Object shape is sampled per
    OBJECT (not per class), so it is appearance noise the mapping must be
    invariant to.

    Returns {'colors' (C, 3) in [0.15, 0.85], 'embeddings' (C, E) unit,
    'latent' (C, 3)}.
    """
    u = _fibonacci_sphere(n_classes)
    rs = np.random.RandomState(seed)
    b = rs.randn(embed_dim, 3).astype(np.float64)
    b, _ = np.linalg.qr(b)                       # orthonormal columns
    emb = (b @ u.T.astype(np.float64)).T
    emb = (emb / np.linalg.norm(emb, axis=-1, keepdims=True)
           ).astype(np.float32)
    colors = (0.5 + 0.35 * u).astype(np.float32)
    return {'colors': colors, 'embeddings': emb, 'latent': u}


def make_open_vocab_detection_set(n_images: int, seed: int,
                                  family: Dict[str, np.ndarray],
                                  class_ids: np.ndarray,
                                  image_size: int = 160,
                                  max_objects: int = 8,
                                  min_side: int = 24,
                                  max_side: int = 64
                                  ) -> Dict[str, np.ndarray]:
    """Synthetic detection set over a subset of an open-vocab family.

    class_ids: the FAMILY class ids usable in these images (train subset
    or held-out subset). Emitted labels are LOCAL indices into class_ids
    (matching a vocabulary built as family['embeddings'][class_ids]).
    Same schema as `make_synth_detection_set`.
    """
    rs = np.random.RandomState(seed)
    S, M = image_size, max_objects
    colors = family['colors']
    images = np.empty((n_images, S, S, 3), np.float32)
    boxes = np.zeros((n_images, M, 4), np.float32)
    cids = np.zeros((n_images, M), np.int32)
    valid = np.zeros((n_images, M), bool)

    for i in range(n_images):
        img = np.clip(0.25 + 0.06 * rs.randn(S, S, 3), 0, 1
                      ).astype(np.float32)
        n_obj = rs.randint(2, 6)
        placed = []
        for _ in range(n_obj):
            for _attempt in range(20):
                w = rs.randint(min_side, max_side + 1)
                h = rs.randint(min_side, max_side + 1)
                x0 = rs.randint(0, S - w)
                y0 = rs.randint(0, S - h)
                box = np.array([x0, y0, x0 + w, y0 + h], np.float32)
                ok = True
                for pb in placed:
                    ix = max(0, min(box[2], pb[0][2]) - max(box[0], pb[0][0]))
                    iy = max(0, min(box[3], pb[0][3]) - max(box[1], pb[0][1]))
                    inter = ix * iy
                    union = (w * h + (pb[0][2] - pb[0][0])
                             * (pb[0][3] - pb[0][1]) - inter)
                    if inter / union > 0.35:
                        ok = False
                        break
                if ok:
                    break
            else:
                continue
            local = rs.randint(0, len(class_ids))
            fam_cls = int(class_ids[local])
            shape = ('square', 'circle', 'triangle')[rs.randint(3)]
            _draw_colored(img, colors[fam_cls], shape, x0, y0, w, h, rs)
            placed.append((box, local))
        images[i] = img
        for j, (box, local) in enumerate(placed[:M]):
            boxes[i, j] = box
            cids[i, j] = local
            valid[i, j] = True
    return {'images': images, 'boxes': boxes, 'class_ids': cids,
            'valid_mask': valid}


def _draw_colored(img: np.ndarray, color: np.ndarray, shape: str,
                  x0: int, y0: int, w: int, h: int,
                  rs: np.random.RandomState) -> None:
    """Draw one object of an explicit color + shape (open-vocab family:
    color carries the class identity, shape is per-object noise)."""
    c = np.clip(color + rs.uniform(-0.05, 0.05, 3), 0, 1)
    H, W = img.shape[:2]
    yy, xx = np.mgrid[0:H, 0:W]
    if shape == 'square':
        mask = (xx >= x0) & (xx < x0 + w) & (yy >= y0) & (yy < y0 + h)
    elif shape == 'circle':
        cx, cy = x0 + w / 2.0, y0 + h / 2.0
        mask = (((xx - cx) / (w / 2.0)) ** 2
                + ((yy - cy) / (h / 2.0)) ** 2) <= 1.0
    else:
        ty = (yy - y0) / max(h - 1, 1)
        half = np.clip(ty, 0, 1) * (w / 2.0)
        cx = x0 + w / 2.0
        mask = (yy >= y0) & (yy < y0 + h) & (np.abs(xx - cx) <= half)
    img[mask] = c.astype(np.float32)
