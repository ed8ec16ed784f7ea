"""Runs the plain reference over the frames whose answers are judged, in
blocks, and judges each answer (`judge.py`).

It is given only what the benchmark made (the seeded weights, the
vocabulary rows, the frames) and the system's answers; it works out the
canvases, scales, boxes and scores again.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from perfbench.lib import judge
from perfbench.reference.letterbox import device_letterbox
from perfbench.reference.model import YOLOCLIPReference, fp32_strict


@dataclass
class Item:
    """One frame and every distinct answer the system gave for it. An
    answer is (boxes (n, 4), scores (n,), class ids (n,)), best first."""
    frame: np.ndarray
    answers: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = field(
        default_factory=list)


def reference_model(cfg: Dict, state_dict: Dict[str, torch.Tensor],
                    device) -> YOLOCLIPReference:
    m = YOLOCLIPReference(cfg['backbone_variant'], cfg['embed_dim'],
                          cfg['hidden_dim'], cfg['reg_max'],
                          cfg['neck_bottlenecks'], cfg['strides'])
    m.load_state_dict({k: v.float() if v.is_floating_point() else v
                       for k, v in state_dict.items()})
    return m.to(device).eval()


def _canvases(frames: Sequence[np.ndarray], target, device):
    """(float32 canvases (N, th, tw, 3) in [0, 1], scale, original (w, h))
    of same-size frames letterboxed as the batch path does it."""
    x = torch.from_numpy(np.stack(frames)).to(device)
    canv, scale = device_letterbox(x, target)
    h, w = frames[0].shape[:2]
    return canv, scale, (w, h)


def check(items: Sequence[Item], cfg: Dict, model: YOLOCLIPReference,
          text: torch.Tensor, device, block: int = 8
          ) -> Tuple[List[Dict[str, float]], List[Dict]]:
    """(readings of every answer of every item, each item's pool: its
    count of anchors above the confidence threshold and its nms_topk-th
    best score by the reference), the reference run `block`
    frames at a time."""
    target = tuple(cfg['image_size'])
    th, tw = target
    shapes = [(th // s, tw // s) for s in cfg['strides']]
    stride = judge.anchor_strides(shapes, cfg['strides'], device)
    readings: List[Dict[str, float]] = []
    pools: List[Dict] = [{} for _ in items]
    text = text.to(device, torch.float32)
    with torch.no_grad(), fp32_strict():
        # the letterbox takes frames of one size a block
        order = sorted(range(len(items)),
                       key=lambda i: items[i].frame.shape)
        for at in range(0, len(order), block):
            groups: Dict[tuple, list] = {}
            for i in order[at:at + block]:
                groups.setdefault(items[i].frame.shape, []).append(i)
            for group in groups.values():
                canv, scale, (w, h) = _canvases([items[i].frame
                                                 for i in group],
                                                target, device)
                boxes, sims = model(canv.permute(0, 3, 1, 2), text)
                hi = torch.tensor([w, h, w, h], dtype=torch.float32,
                                  device=device)
                for k, i in enumerate(group):
                    b = boxes[k] / torch.tensor(np.float32(scale),
                                                device=device)
                    b = torch.minimum(b.clamp_min(0), hi)
                    best = sims[k].max(-1).values
                    above = int((best > cfg['conf_threshold']).sum())
                    pools[i] = {
                        'above': above,
                        'kth': float(best.topk(min(cfg['nms_topk'],
                                                   best.numel())).values[-1])}
                    for ab, asc, acl in items[i].answers:
                        readings.append(judge.judge_image(
                            b, sims[k], torch.from_numpy(ab),
                            torch.from_numpy(asc), torch.from_numpy(acl),
                            slots=cfg['max_detections'],
                            conf=cfg['conf_threshold'],
                            iou_threshold=cfg['iou_threshold'],
                            topk=cfg['nms_topk'], stride=stride,
                            scale=scale))
                del boxes, sims, canv
    return readings, pools
