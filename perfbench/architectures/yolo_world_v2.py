"""YOLO-World v2 (Cheng et al., arXiv:2401.17270; github.com/AILab-CVC/
YOLO-World): YOLOv8 C2f backbone, `YOLOWorldPAFPN` with multi-head
max-sigmoid text attention, BatchNorm contrastive head with sigmoid scores,
DFL boxes decoded as ltrb distances from anchor centres. The plain
reference is `perfbench/reference/yolo_world_v2.py`.

Seeded weights keep the published initialisation (`init_kind`: lecun-
normal kernels, zero biases, BatchNorm weight BN_GAIN and calibrated
statistics), with two stated priors on top (`seeded_state_dict`):
  * each `BNContrastiveHead`'s `logit_scale` and `bias`. mmyolo's
    initialisation (logit_scale -1, bias log(5 / C / (640 / stride)^2))
    puts every seeded sigmoid score at 1e-6 at C = 1203, and its
    logit_scale with a zero bias at 0.5 +- 0.02: no detection clears a
    threshold, or every score ties. The prior, exp(logit_scale) 0.5 and
    bias -2.75, maps the raw BN(embed) . t_hat of each frame's 1100th-best
    anchor (1.11-1.32 on the H100, 64 seeded frames on each of two seeds)
    to a sigmoid score of 0.1 or more, the configuration's threshold, so
    the NMS pool fills as a trained detector's does at a low threshold;
    and at that slope bf16 rounding stays under the comparison's score
    tail limit while the int8 path's error does not (PERF.md, section 2,
    gives the sweep over scale and threshold it was read from);
  * the reg towers' last biases at -DFL_SLOPE k on DFL bin k (mmyolo sets
    them to a constant, so the bins start uniform and every box 15
    strides wide), so seeded boxes come out at object scale (about 3
    strides) and neighbours overlap as real candidates do.

The control is the system's int8 path (`quantize_int8`, W8A8): it builds
for these blocks (the no-SiLU blocks dequantize the int8 kernel's
accumulator), and it is the step below the configuration's bf16."""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch

from perfbench.lib import roofline, weights
from perfbench.reference.model import VARIANTS
from perfbench.reference.yolo_world_v2 import YOLOWorldV2Reference

model_fields = ('family', 'backbone_variant', 'embed_dim', 'hidden_dim',
                'reg_max', 'neck_bottlenecks', 'strides')

# The contrastive heads' prior: exp(LOGIT_SCALE) and LOGIT_BIAS, every
# level (see the module docstring).
LOGIT_SCALE = math.log(0.5)
LOGIT_BIAS = -2.75
# The reg towers' prior: -DFL_SLOPE k on DFL bin k.
DFL_SLOPE = 0.5

# mmyolo's YOLOv8 backbone: bottlenecks a stage before the depth multiple,
# and the last stage's width before the width multiple by variant
# (`last_stage_out_channels`).
STAGE_BLOCKS = (3, 6, 6, 3)
LAST_STAGE = {'n': 1024, 's': 1024, 'm': 768, 'l': 512, 'x': 512}


def channels(cfg: Dict) -> Tuple[list, list]:
    """(the five backbone widths, the four stages' bottleneck counts) of
    the configuration's variant, as mmyolo's YOLOv8CSPDarknet derives
    them (depths rounded, as its `make_round`)."""
    v = cfg['backbone_variant']
    w, d = VARIANTS[v]
    ch = [max(int(x * w), 16) for x in (64, 128, 256, 512, LAST_STAGE[v])]
    dp = [max(round(n * d), 1) for n in STAGE_BLOCKS]
    return ch, dp


def reference(cfg: Dict) -> YOLOWorldV2Reference:
    """Scores are sigmoid probabilities (B, A, C)."""
    ch, dp = channels(cfg)
    return YOLOWorldV2Reference(
        ch, dp, cfg['embed_dim'], cfg['hidden_dim'], cfg['reg_max'],
        cfg['neck_bottlenecks'], cfg['strides'])


def state_shapes(cfg: Dict) -> Dict[str, Tuple[int, ...]]:
    with torch.device('meta'):
        m = reference(cfg)
    return {k: tuple(v.shape) for k, v in m.state_dict().items()}


def seeded_state_dict(cfg: Dict, seed: int, device
                      ) -> Dict[str, torch.Tensor]:
    """The default init kinds, then the priors of the module docstring."""
    sd = weights.seeded_state_dict(state_shapes(cfg), seed, device)
    bins = cfg['reg_max'] + 1
    prior = (-DFL_SLOPE * torch.arange(bins, dtype=torch.float32,
                                       device=device)).repeat(4)
    for k in sd:
        if k.startswith('bbox_head.head_module.reg_preds.') and \
                k.endswith('.2.bias'):
            sd[k] = prior.clone()
        elif k.startswith('bbox_head.head_module.cls_contrasts.'):
            if k.endswith('.logit_scale'):
                sd[k] = torch.full((), LOGIT_SCALE, device=device)
            elif k.endswith('.bias') and '.bn.' not in k:
                sd[k] = torch.full((), LOGIT_BIAS, device=device)
    return sd


def flops_per_image(cfg: Dict, classes: int, hw: Sequence[int]) -> float:
    return roofline.forward_flops(
        lambda: reference(cfg), (1, 3) + tuple(hw),
        (classes, cfg['embed_dim']))


def control(det, frames) -> None:
    """The system's int8 path (W8A8, calibrated on 8 of the frames): the
    step below the configuration's bf16."""
    det.quantize_int8(frames[:8])
