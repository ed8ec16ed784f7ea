"""Seeded inputs: detector weights, vocabulary rows and frames.

Everything is drawn on the card (or the device given) from one
`torch.Generator` seeded with the run's `--seed`, in a few large calls,
so the same seed gives the same inputs and set-up stays short.

Weights follow the system's own random-init rule (lecun-normal conv and
linear kernels, zero biases, xavier-uniform attention projections), with
its one prior: the box towers' last biases are -k on DFL bin k, so random
boxes come out at object scale and overlap as real candidates do. With
identity BatchNorm such a network's activations shrink by about half a
layer (to 1e-6 of the input at the heads), so the box towers' output is
their bias alone and every anchor's box has one shape. So the BatchNorm
statistics are set as a trained network's are: each layer's running mean
and variance are those of its input over a seeded calibration batch, run
through the plain reference (`calibrate_batchnorm`), and every BatchNorm
scales by BN_GAIN. Every layer then hands on activations of one scale,
and boxes, scores and classes depend on the frame. At a gain of 1 the
SiLU network is chaotic (a rounding error grows about 1.2 times a layer,
so bf16 and float32 answers part completely at YOLOv8l's depth); at 0.25
it is not. The weights are keyed in the reference layout, which the
system loads with `state_dict=`.
"""

from __future__ import annotations

import json
import math
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

INT63 = (1 << 63) - 1
BN_GAIN = 0.25


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) & INT63)
    return g


def _kind(key: str, shape: Tuple[int, ...]) -> str:
    if key.endswith('num_batches_tracked'):
        return 'zero_long'
    if '.bn.' in key:
        return 'one' if key.endswith(('weight', 'running_var')) else 'zero'
    if key.endswith('in_proj_weight'):
        return 'xavier'
    if key.endswith('weight') and len(shape) >= 2:
        return 'lecun'
    return 'zero'


def seeded_state_dict(shapes: Dict[str, Tuple[int, ...]], seed: int,
                      device, reg_max: int = 16) -> Dict[str, torch.Tensor]:
    """Float32 weights for every key of `shapes`, drawn in two calls: one
    normal draw for every lecun-normal kernel, one uniform draw for the
    attention projections."""
    g = generator(seed, device)
    out: Dict[str, torch.Tensor] = {}
    normal = [(k, s) for k, s in shapes.items() if _kind(k, s) == 'lecun']
    xavier = [(k, s) for k, s in shapes.items() if _kind(k, s) == 'xavier']
    for keys, draw in ((normal, 'normal'), (xavier, 'uniform')):
        total = sum(math.prod(s) for _, s in keys)
        flat = torch.empty(total, device=device)
        if draw == 'normal':
            flat.normal_(generator=g)
        else:
            flat.uniform_(-1, 1, generator=g)
        at = 0
        for k, s in keys:
            n = math.prod(s)
            w = flat[at:at + n].view(s)
            at += n
            if draw == 'normal':
                w.mul_(1.0 / math.sqrt(n // s[0]))
            else:
                w.mul_(math.sqrt(6.0 / (s[0] + s[1])))
            out[k] = w
    for k, s in shapes.items():
        kind = _kind(k, s)
        if kind == 'one':
            out[k] = torch.full(s, BN_GAIN if k.endswith('.bn.weight')
                                else 1.0, device=device)
        elif kind == 'zero':
            out[k] = torch.zeros(s, device=device)
        elif kind == 'zero_long':
            out[k] = torch.zeros(s, dtype=torch.int64, device=device)
    prior = -torch.arange(reg_max + 1, dtype=torch.float32,
                          device=device).repeat(4)
    for k in shapes:
        if k.startswith('box_head.box_convs.') and k.endswith('.2.bias'):
            out[k] = prior.clone()
    return out


# Calibration canvases: the share of the canvas's rows a frame fills, as a
# 4:3 frame (480x640) and a 16:9 one (720p, 1080p) letterboxed into a
# square canvas leave the rest black.
FILLED_ROWS = (0.75, 0.5625, 0.75, 0.5625)


def calibrate_batchnorm(sd: Dict[str, torch.Tensor], cfg: Dict,
                        text: torch.Tensor, seed: int, device
                        ) -> Dict[str, torch.Tensor]:
    """Set every BatchNorm's running mean and variance in `sd` to the
    statistics of its input over seeded letterboxed noise canvases at the
    configuration's image size (noise in the rows a frame fills, black
    below, as the cells' frames arrive), each layer seeing the layers
    before it already normalised (one float32 forward of the reference in
    train mode, with a cumulative average over the one batch). Canvases of
    noise alone would leave deep features of nearly no spatial variance,
    which a black border then blows up."""
    from perfbench.reference.model import YOLOCLIPReference, fp32_strict
    model = YOLOCLIPReference(cfg['backbone_variant'], cfg['embed_dim'],
                              cfg['hidden_dim'], cfg['reg_max'],
                              cfg['neck_bottlenecks'], cfg['strides'])
    model.load_state_dict(sd)
    model.to(device).train()
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.momentum = None
            m.reset_running_stats()
    g = generator(seed ^ 0xCA11B, device)
    h, w = cfg['image_size']
    x = torch.rand((len(FILLED_ROWS), 3, h, w), generator=g, device=device)
    for i, share in enumerate(FILLED_ROWS):
        x[i, :, int(h * share):] = 0
    with torch.no_grad(), fp32_strict():
        model(x, text.to(device))
    out = dict(sd)
    for k, v in model.state_dict().items():
        if '.bn.running_' in k:
            out[k] = v.detach()
    return out


def vocabulary(classes: int, dim: int, seed: int, device
               ) -> Tuple[List[str], torch.Tensor]:
    """(synthetic class names, (classes, dim) float32 unit rows)."""
    g = generator(seed ^ 0x5EED, device)
    rows = torch.randn((classes, dim), generator=g, device=device)
    rows = rows / rows.norm(dim=-1, keepdim=True)
    names = [f'class {i:04d}' for i in range(classes)]
    return names, rows


def frames(n: int, hw: Tuple[int, int], seed: int, salt: int, device
           ) -> np.ndarray:
    """n uint8 (H, W, 3) frames of uniform noise, drawn on `device`,
    returned as pageable host memory (as a user's frames arrive)."""
    g = generator(seed ^ (salt * 0x9E3779B1), device)
    x = torch.randint(0, 256, (n, hw[0], hw[1], 3), generator=g,
                      device=device, dtype=torch.uint8)
    return x.cpu().numpy()


def vocab_file(names: Sequence[str], rows: torch.Tensor) -> str:
    """Write the offline-vocabulary JSON the system reads ({name:
    [floats]}, every float32 value exact) under the run's temporary
    directory (TMPDIR) and return its path."""
    import tempfile
    fd, path = tempfile.mkstemp(prefix='perfbench-vocab-', suffix='.json')
    host = rows.cpu().numpy().astype(np.float32)
    with os.fdopen(fd, 'w') as f:
        json.dump({n: r.tolist() for n, r in zip(names, host)}, f)
    return path
