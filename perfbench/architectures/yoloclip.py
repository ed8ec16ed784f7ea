"""YOLO-CLIP, the system's own architecture: YOLOv8 CSPDarknet, RepVL-PAN
(image-pooling attention, max-sigmoid text gates), heads scored by raw
cosine against the text, boxes by DFL decoded as xy + exp(wh). The plain
reference is `perfbench/reference/model.py`."""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from perfbench.lib import roofline, weights
from perfbench.reference.model import YOLOCLIPReference

# The widths a configuration may leave out: the reference's and the
# system's `ModelConfig` defaults alike.
DEFAULTS = {'embed_dim': 512, 'hidden_dim': 256, 'reg_max': 16,
            'neck_bottlenecks': 2, 'strides': (8, 16, 32)}

model_fields = ('backbone_variant', 'embed_dim', 'hidden_dim', 'reg_max',
                'neck_bottlenecks', 'strides')


def _widths(cfg: Dict) -> Dict:
    return {**DEFAULTS, **cfg}


def reference(cfg: Dict) -> YOLOCLIPReference:
    """Scores are cosines (B, A, C), thresholded as they are."""
    c = _widths(cfg)
    return YOLOCLIPReference(c['backbone_variant'], c['embed_dim'],
                             c['hidden_dim'], c['reg_max'],
                             c['neck_bottlenecks'], c['strides'])


def state_shapes(cfg: Dict) -> Dict[str, Tuple[int, ...]]:
    with torch.device('meta'):
        m = reference(cfg)
    return {k: tuple(v.shape) for k, v in m.state_dict().items()}


def seeded_state_dict(cfg: Dict, seed: int, device
                      ) -> Dict[str, torch.Tensor]:
    """The default init kinds, and the box towers' last biases at -k on
    DFL bin k, so random boxes come out at object scale and overlap as
    real candidates do."""
    sd = weights.seeded_state_dict(state_shapes(cfg), seed, device)
    prior = -torch.arange(_widths(cfg)['reg_max'] + 1, dtype=torch.float32,
                          device=device).repeat(4)
    for k in sd:
        if k.startswith('box_head.box_convs.') and k.endswith('.2.bias'):
            sd[k] = prior.clone()
    return sd


def flops_per_image(cfg: Dict, classes: int, hw: Sequence[int]) -> float:
    return roofline.forward_flops(
        lambda: reference(cfg), (1, 3) + tuple(hw),
        (classes, _widths(cfg)['embed_dim']))


def control(det, frames) -> None:
    """The system's int8 path (W8A8, calibrated on 8 of the frames): the
    step below the configurations' bf16."""
    det.quantize_int8(frames[:8])
