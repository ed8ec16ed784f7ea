"""Post-training W8A8 int8 quantization for the deploy graph. Counterpart of
`yoloclip_tpu/ops/quantize.py`.

Scheme (symmetric, zero-point 0, so zero padding stays exact), as in the
JAX package:
  * selective: blocks passing `models.layers.quant_eligible` (wide 3x3
    convs) become int8 convs; every other ConvBlock becomes a BN-folded
    float conv {wf, fbias};
  * weights: BatchNorm folded into the kernel first, in fp32 on the host
    (s = gamma / sqrt(var + eps), w' = w s, b' = beta - mean s), then
    per-output-channel scales wscale = max(max|w'| / 127, 1e-12) and
    wq = clip(round_half_even(w' / wscale), -127, 127);
  * activations: one scale a block, act_scale = max(amax / 127, 1e-12),
    from the max-abs of the block's input over a short calibration run
    ('max'), or from its 99.9th percentile ('percentile', max-reduced over
    batches);
  * int8-stored edges: a `store_out` block whose output is eligible
    (`models.layers.store_int8_eligible` at calibration) also gets
    out_scale = max(out_amax / 127, 1e-12), out_amax the max-abs of its
    float post-SiLU output, in either scheme.

`calibrate_amax` records the input statistics of every ConvBlock with
forward hooks on the float model (the JAX package sows them from a
'calib' graph). `quantize_state` turns a float state dict into the int8
model's; `quantize_model` does both and builds the int8 `YOLOCLIP`;
`build_quant_forward` is the int8 sibling of
`ops/reparam.py::build_reparam_forward`. The int8 convs run through
`ops/kernels/int8_conv.py`. Kept in float, as in the JAX package: the
similarity and its norms, the DFL decode, NMS, I-Pool, the text
projections and the last 1x1 convs of each head tower.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from yoloclip_tpu_torch.models.layers import (ConvBlock, quant_eligible,
                                              store_int8_eligible)
from yoloclip_tpu_torch.models.yolo_clip import (YOLOCLIP, cast_compute_dtype,
                                                 make_model)
from yoloclip_tpu_torch.ops.reparam import build_reparam_forward
from yoloclip_tpu_torch.parallel import spatial

BN_EPS = 1e-5          # ConvBlock's BatchNorm epsilon
_MIN_SCALE = 1e-12
PERCENTILE = 0.999
CALIBRATIONS = ('max', 'percentile')


def percentile_999(ax: torch.Tensor) -> torch.Tensor:
    """The 99.9th percentile of ax's elements (fp32), interpolated linearly
    as `jnp.quantile(ax, 0.999)` computes it: position q (n - 1) in fp32,
    the order statistics at its floor and ceiling, weights in fp32.
    `torch.quantile` refuses inputs above 2^24 elements (a 640-px batch of
    32 stem inputs has 39.3 M); this takes the top n - floor + 1 values
    with `torch.topk` instead of sorting everything."""
    flat = ax.reshape(-1).float()
    n = flat.numel()
    pos = np.float32(PERCENTILE) * (np.float32(n) - np.float32(1))
    lo, hi = np.floor(pos), np.ceil(pos)
    w_hi = np.float32(pos - lo)
    w_lo = np.float32(1) - w_hi
    lo_i = int(min(max(lo, 0), n - 1))
    hi_i = int(min(max(hi, 0), n - 1))
    k = n - lo_i                      # ranks lo_i .. n - 1, largest first
    top = torch.topk(flat, k, largest=True, sorted=True).values
    return top[k - 1] * float(w_lo) + top[k - 1 - (hi_i - lo_i)] * float(
        w_hi)


def calibrate_amax(model: YOLOCLIP, batches: Iterable[Tuple[Any, Any]],
                   percentile: bool = False,
                   **forward_kwargs) -> Dict[str, Dict[str, float]]:
    """Run the float model on each (images, text) batch and return, per
    ConvBlock name, {'in_amax': max |x|} (and {'in_p999': the 99.9th |x|
    percentile} with percentile=True) of its input in fp32, each
    max-reduced over the batches. A `store_out` block whose output passes
    `store_int8_eligible` (the threshold in force) also gets
    {'out_amax': max |y|, 'out_store': 1} of its post-SiLU output y, as
    the JAX package's 'calib' graph sows them. forward_kwargs go to the
    model, so the calibration runs the graph that will be served
    (class_mask, skip_image_pool)."""
    stats: Dict[str, Dict[str, torch.Tensor]] = {}

    def merge(name, cur):
        old = stats.setdefault(name, {})
        for k, v in cur.items():
            old[k] = v if k not in old else torch.maximum(old[k], v)

    def hook(name):
        def record(_module, args):
            ax = args[0].detach().float().abs()
            cur = {'in_amax': ax.max()}
            if percentile:
                cur['in_p999'] = percentile_999(ax)
            merge(name, cur)
        return record

    def out_hook(name):
        def record(_module, _args, y):
            _, c, h, w = y.shape
            if store_int8_eligible(spatial.global_rows(h), w, c):
                merge(name, {'out_amax': y.detach().float().abs().max(),
                             'out_store': y.new_ones((), dtype=torch.float32)})
        return record

    blocks = [(n, m) for n, m in model.named_modules()
              if isinstance(m, ConvBlock)]
    handles = [m.register_forward_pre_hook(hook(n)) for n, m in blocks]
    handles += [m.register_forward_hook(out_hook(n)) for n, m in blocks
                if m.store_out]
    ran = False
    try:
        with torch.inference_mode():
            for images, text in batches:
                model(images, text, **forward_kwargs)
                ran = True
    finally:
        for h in handles:
            h.remove()
    if not ran:
        raise ValueError('calibrate_amax needs at least one batch')
    names = [(n, k) for n, d in stats.items() for k in d]
    values = torch.stack([stats[n][k] for n, k in names]).cpu().numpy()
    out: Dict[str, Dict[str, float]] = {}
    for (n, k), v in zip(names, values):
        out.setdefault(n, {})[k] = np.float32(v)
    return out


def _pick_act_amax(a_node: Optional[Dict], calibration: str):
    """'max' -> 'in_amax'; 'percentile' -> 'in_p999'."""
    if calibration not in CALIBRATIONS:
        raise ValueError(f"calibration must be 'max' or 'percentile', "
                         f'got {calibration!r}')
    if a_node is None:
        return None
    if calibration == 'percentile':
        v = a_node.get('in_p999')
        if v is None and 'in_amax' in a_node:
            raise KeyError("calibration='percentile' needs 'in_p999' "
                           'stats: calibrate with percentile=True '
                           '(quantize_model does this)')
        return v
    return a_node.get('in_amax')


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().float().numpy()


def _out_scale(prefix: str, a_node: Optional[Dict]
               ) -> Dict[str, torch.Tensor]:
    """{prefix.out_scale} where calibration stored the block's output, as
    the JAX package's `_out_scale`; else nothing."""
    if a_node and float(a_node.get('out_store', 0.0)) > 0:
        scale = max(float(a_node['out_amax']) / 127.0, _MIN_SCALE)
        return {f'{prefix}.out_scale': torch.tensor(np.float32(scale))}
    return {}


def _quantize_convblock(sd: Dict[str, torch.Tensor], prefix: str,
                        amax, a_node: Optional[Dict] = None
                        ) -> Dict[str, torch.Tensor]:
    """One ConvBlock's float entries -> its deploy entries (a_node: its
    calibration statistics, for out_scale)."""
    kernel = _np(sd[f'{prefix}.conv.weight'])          # (O, I, k, k)
    gamma = _np(sd[f'{prefix}.bn.weight'])
    beta = _np(sd[f'{prefix}.bn.bias'])
    mean = _np(sd[f'{prefix}.bn.running_mean'])
    var = _np(sd[f'{prefix}.bn.running_var'])

    s = gamma / np.sqrt(var + BN_EPS)
    w = kernel * s[:, None, None, None]
    b = beta - mean * s

    cout, cin, k = kernel.shape[:3]
    if not quant_eligible(k, cin, cout):
        return {f'{prefix}.wf': torch.from_numpy(w.astype(np.float32)),
                f'{prefix}.fbias': torch.from_numpy(b.astype(np.float32)),
                **_out_scale(prefix, a_node)}
    if amax is None:
        raise KeyError('missing calibration amax for eligible ConvBlock '
                       '(run calibrate_amax first)')
    wscale = np.maximum(np.abs(w).max(axis=(1, 2, 3)) / 127.0, _MIN_SCALE)
    wq = np.clip(np.round(w / wscale[:, None, None, None]), -127,
                 127).astype(np.int8)
    act_scale = np.float32(max(float(amax) / 127.0, _MIN_SCALE))
    return {
        f'{prefix}.wq': torch.from_numpy(
            np.ascontiguousarray(wq.transpose(0, 2, 3, 1))),
        f'{prefix}.wscale': torch.from_numpy(wscale.astype(np.float32)),
        f'{prefix}.qbias': torch.from_numpy(b.astype(np.float32)),
        f'{prefix}.act_scale': torch.tensor(act_scale),
    }


def quantize_state(state_dict: Dict[str, torch.Tensor],
                   amax: Dict[str, Dict[str, float]],
                   calibration: str = 'max') -> Dict[str, torch.Tensor]:
    """A float model's state dict (fp32 weights) -> the int8 model's: every
    ConvBlock (`{p}.conv.weight` + `{p}.bn.*`) becomes {wq, wscale, qbias,
    act_scale} (if `quant_eligible`) or the BN-folded {wf, fbias}, using
    `amax` from `calibrate_amax`, plus `out_scale` where calibration
    stored the block's output; everything else passes through."""
    _pick_act_amax(None, calibration)       # validates the scheme
    prefixes = [k[:-len('.conv.weight')] for k in state_dict
                if k.endswith('.conv.weight')
                and k[:-len('conv.weight')] + 'bn.weight' in state_dict]
    out = {k: v for k, v in state_dict.items()
           if not any(k.startswith(p + '.conv.') or k.startswith(p + '.bn.')
                      for p in prefixes)}
    for p in prefixes:
        try:
            out.update(_quantize_convblock(
                state_dict, p, _pick_act_amax(amax.get(p), calibration),
                amax.get(p)))
        except KeyError as e:
            raise KeyError(f'{e.args[0]}: ConvBlock {p}') from None
    return out


def float_state(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """A copy of the model's state dict on the host, floats in fp32."""
    return {k: (v.detach().cpu().float() if v.is_floating_point()
                else v.detach().cpu()).clone()
            for k, v in model.state_dict().items()}


def quantize_model(model: YOLOCLIP, state_dict: Dict[str, torch.Tensor],
                   calib_batches: Iterable[Tuple[Any, Any]],
                   calibration: str = 'max', **forward_kwargs) -> YOLOCLIP:
    """(float model, its fp32 state dict, calibration batches) -> the int8
    model of its family (`make_model`: a YOLOCLIP, or a
    YOLOWorldV2, whose no-SiLU blocks dequantize the int8 kernel's
    accumulator), on the model's device in its compute dtype, as the JAX
    package's `quantize_model(cfg, variables, ...)`. Calibrates with the
    model as it runs (forward_kwargs: class_mask, skip_image_pool) and
    folds from `state_dict`, the fp32 weights the model was built from
    (`float_state` of an fp32 model), never from a bf16-cast model."""
    _pick_act_amax(None, calibration)
    amax = calibrate_amax(model, calib_batches,
                          percentile=calibration == 'percentile',
                          **forward_kwargs)
    qsd = quantize_state(state_dict, amax, calibration)
    aux = 'contrastive_heads.0.box_conv.0.conv.weight' in state_dict
    qmodel = make_model(dataclasses.replace(model.cfg, quant='int8'),
                        with_aux_box=aux)
    qmodel.load_state_dict(qsd, strict=True)
    device = next(model.parameters()).device
    return cast_compute_dtype(qmodel.to(device), model.compute_dtype).eval()


def build_quant_forward(model: YOLOCLIP, state_dict: Dict[str, torch.Tensor],
                        vocabulary: torch.Tensor, calib_images: torch.Tensor,
                        class_mask: Optional[torch.Tensor] = None,
                        fused_scores: Optional[bool] = None,
                        skip_image_pool: bool = False,
                        nms: Optional[Dict] = None,
                        calibration: str = 'max'
                        ) -> Callable[[torch.Tensor], Dict[str, torch.Tensor]]:
    """The int8 sibling of `build_reparam_forward`: quantize `model` (its
    fp32 weights `state_dict`), calibrated on `calib_images` (a
    representative (N, H, W, 3) float batch on the model's device) against
    `vocabulary`, and return `fn(images)` running the int8 graph with the
    vocabulary bound (and NMS, with nms=...)."""
    device = next(model.parameters()).device
    vocab = torch.as_tensor(vocabulary, device=device)
    mask = (None if class_mask is None
            else torch.as_tensor(class_mask, device=device))
    qmodel = quantize_model(
        model, state_dict,
        [(torch.as_tensor(calib_images, device=device), vocab)],
        calibration, class_mask=mask, skip_image_pool=skip_image_pool)
    return build_reparam_forward(qmodel, vocab, mask, fused_scores,
                                 skip_image_pool, nms)
