"""Train state, optimizer, schedule and the train / eval steps. Counterpart
of `yoloclip_tpu/train/train_state.py`.

  * The optimizer is torch's AdamW (or SGD with momentum 0.9), the math of
    optax's: eps outside the square root, decoupled weight decay on every
    parameter, BatchNorm's affine included.
  * The learning rate is the original repo's OneCycle curve
    (`make_onecycle_schedule`), written into the optimizer's param groups
    by the trainer in epoch or step units; counts past the end clamp to
    the final rate (torch's `OneCycleLR` raises there).
  * EMA of the parameters only, decay ramped as
    decay * (1 - exp(-(step + 1) / warmup)); evaluation runs the EMA
    parameters with the model's current BatchNorm buffers.
  * Gradient accumulation splits the batch into equal micro-batches: the
    BatchNorm statistics update once per micro-batch, in order, and the
    gradients and loss parts average over them.
  * bf16 computes the forward under `torch.autocast` (convs, linears and
    matmuls in bf16, weights cast at use); the parameters, gradients,
    optimizer state, EMA and every loss stay fp32.
  * Data parallelism (`parallel/train_step.py`): the forward runs through
    a DistributedDataParallel wrapper of the model (no gradient all-reduce
    on all but the last micro-batch), the losses normalise over the global
    batch, and the returned loss parts are the global batch's (averaged
    over the ranks), as the JAX package's sharded step returns them.
  * Class parallelism (the 'model' axis): the text is the rank's block of
    the classes (`shard_text` gives its `ClassShard`), which the model and
    the losses merge over the model group.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn
from torch.func import functional_call

from yoloclip_tpu_torch.config import TrainingConfig
from yoloclip_tpu_torch.ops.nms import batched_nms
from yoloclip_tpu_torch.parallel.collectives import group_mean
from yoloclip_tpu_torch.train.assign import anchor_points
from yoloclip_tpu_torch.train.losses import (combined_loss_clean,
                                             combined_loss_compat)

TRAIN_KEYS = ('loss', 'contrastive_loss', 'iou_loss', 'dfl_loss')


class TrainState:
    """A model whose parameters are the fp32 master weights, its optimizer,
    the EMA of its parameters ({name: tensor}, or None) and the number of
    optimizer steps taken (a host int: reading it never syncs the card)."""

    def __init__(self, model: nn.Module, optimizer: torch.optim.Optimizer,
                 ema: Optional[Dict[str, torch.Tensor]] = None,
                 step: int = 0):
        self.model = model
        self.optimizer = optimizer
        self.ema = ema
        self.step = step

    def eval_params(self) -> Dict[str, torch.Tensor]:
        """The parameters to evaluate and serve: the EMA when tracked, else
        the raw ones; the BatchNorm buffers are always the model's."""
        if self.ema is not None:
            return self.ema
        return dict(self.model.named_parameters())


def _cos_interp(a: float, b: float, t: float) -> float:
    """Cosine interpolation from a (t=0) to b (t=1)."""
    return b + (a - b) * (1 + math.cos(math.pi * t)) / 2


def make_onecycle_schedule(base_lr: float, total_steps: int,
                           warmup_steps: int, div_factor: float = 25.0,
                           final_div_factor: float = 1e4
                           ) -> Callable[[int], float]:
    """torch's `OneCycleLR` curve (anneal 'cos', two phases, pct_start =
    warmup_steps / total_steps): sched(count) is the lr after `count`
    scheduler steps. The peak sits at count warmup_steps - 1 and the final
    lr at total_steps - 1; later counts clamp to the final lr."""
    last = float(max(int(total_steps), 1) - 1)
    boundary = float(warmup_steps) - 1.0
    init = base_lr / div_factor
    final = init / final_div_factor

    def sched(count) -> float:
        count = min(max(float(count), 0.0), last)
        if count <= boundary:
            return _cos_interp(init, base_lr, count / max(boundary, 1e-12))
        return _cos_interp(base_lr, final,
                           (count - boundary) / max(last - boundary, 1e-12))

    return sched


def make_optimizer(cfg: TrainingConfig, params) -> torch.optim.Optimizer:
    """AdamW (betas 0.9/0.999, eps 1e-8, decoupled decay on every
    parameter) or SGD with momentum 0.9, at cfg.learning_rate."""
    if cfg.optimizer_type.lower() == 'adamw':
        return torch.optim.AdamW(params, lr=cfg.learning_rate,
                                 betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=cfg.weight_decay)
    if cfg.optimizer_type.lower() == 'sgd':
        return torch.optim.SGD(params, lr=cfg.learning_rate, momentum=0.9)
    raise ValueError(f'Unknown optimizer {cfg.optimizer_type}')


def set_learning_rate(state: TrainState, lr: float) -> None:
    for group in state.optimizer.param_groups:
        group['lr'] = float(lr)


def get_learning_rate(state: TrainState) -> float:
    return float(state.optimizer.param_groups[0]['lr'])


def create_train_state(model: nn.Module, cfg: TrainingConfig,
                       device='cuda') -> TrainState:
    """Move the model (fp32 weights) to `device` and build its optimizer
    and, when cfg.ema_decay > 0, an EMA copy of its parameters."""
    model = model.to(device=device, dtype=torch.float32)
    ema = None
    if cfg.ema_decay > 0:
        ema = {k: p.detach().clone() for k, p in model.named_parameters()}
    return TrainState(model, make_optimizer(cfg, model.parameters()), ema)


def _autocast(cfg: TrainingConfig, device: torch.device):
    return torch.autocast(device.type, dtype=torch.bfloat16,
                          enabled=cfg.model.dtype == 'bfloat16')


def _mean_parts(parts: Dict[str, torch.Tensor], group
                ) -> Dict[str, torch.Tensor]:
    """Each rank's loss parts -> the global batch's, in one all-reduce."""
    if group is None:
        return parts
    keys = list(parts)
    vals = group_mean(torch.stack([parts[k] for k in keys]), group)
    return dict(zip(keys, vals.unbind(0)))


def make_train_step(cfg: TrainingConfig, ddp=None, group=None,
                    shard_text: Optional[Callable] = None):
    """train_step(state, batch, text) -> loss parts (0-d fp32 tensors on
    the device). Updates the state in place: BatchNorm buffers, parameters
    (one optimizer step at the lr in the param groups), EMA and step.

    batch: images (B, H, W, 3) float [0, 1], boxes (B, M, 4), class_ids
    (B, M), valid_mask (B, M), tensors on the model's device. text:
    (B, C, E) per sample (zero-padded vocabularies) or (C, E) shared.

    ddp / group (`parallel/train_step.py::make_sharded_train_step`): the
    DistributedDataParallel wrapper of state.model and the data axis's
    process group; the batch is then this rank's rows, laid out so that
    its micro-batch i is its share of the global micro-batch i.
    shard_text: text -> its ClassShard, when the text is this rank's
    block of the classes (a mesh with a model axis)."""
    weights = dict(cfg.loss_weights)
    accum = max(int(cfg.grad_accum_steps), 1)
    warmup = max(float(cfg.ema_warmup_steps), 1.0)
    anchors: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}

    def compute_loss(outputs, batch, shard):
        if cfg.assigner == 'topk_center':
            dev = outputs['boxes'].device
            if dev not in anchors:
                anchors[dev] = anchor_points(cfg.model.strides,
                                             cfg.model.image_size, dev)
            pts, strides = anchors[dev]
            return combined_loss_clean(
                outputs, batch, weights, pts, strides,
                temperature=cfg.temperature, iou_type=cfg.iou_type,
                label_smoothing=cfg.label_smoothing,
                reg_max=cfg.model.reg_max,
                contrastive_type=cfg.contrastive_type, group=group,
                class_shard=shard)
        return combined_loss_compat(
            outputs, batch, weights, temperature=cfg.temperature,
            iou_type=cfg.iou_type, label_smoothing=cfg.label_smoothing,
            group=group, class_shard=shard)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   text: torch.Tensor) -> Dict[str, torch.Tensor]:
        model = state.model.train()
        forward = model if ddp is None else ddp
        state.optimizer.zero_grad(set_to_none=True)
        B = batch['images'].shape[0]
        if B % accum:
            raise ValueError(f'batch size {B} not divisible by '
                             f'grad_accum_steps {accum}')
        b = B // accum
        shard = shard_text(text) if shard_text is not None else None
        kw = {} if shard is None else {'class_shard': shard}
        parts_sum: Dict[str, torch.Tensor] = {}
        for i in range(accum):
            sl = slice(i * b, (i + 1) * b)
            mb = {k: batch[k][sl] for k in
                  ('images', 'boxes', 'class_ids', 'valid_mask')}
            tx = text[sl] if text.dim() == 3 else text
            # DDP all-reduces the gradients on the last micro-batch only
            with (ddp.no_sync() if ddp is not None and i < accum - 1
                  else contextlib.nullcontext()):
                with _autocast(cfg, mb['images'].device):
                    outputs = forward(mb['images'], tx, **kw)
                total, parts = compute_loss(outputs, mb, shard)
                (total / accum if accum > 1 else total).backward()
            for k, v in parts.items():
                v = v.detach()
                parts_sum[k] = v if k not in parts_sum else parts_sum[k] + v
        state.optimizer.step()
        if state.ema is not None:
            d = cfg.ema_decay * (1 - math.exp(-(state.step + 1) / warmup))
            ema = list(state.ema.values())
            params = [p.detach() for p in model.parameters()]
            torch._foreach_mul_(ema, d)
            torch._foreach_add_(ema, params, alpha=1 - d)
        state.step += 1
        if accum > 1:
            parts_sum = {k: v / accum for k, v in parts_sum.items()}
        return _mean_parts(parts_sum, group)

    return train_step


def make_eval_step(cfg: TrainingConfig, group=None,
                   shard_text: Optional[Callable] = None):
    """eval_step(state, batch, text) -> (loss parts without DFL, preds).

    The model runs in eval mode with `state.eval_params()` (EMA when
    tracked) and its current BatchNorm buffers. preds: the raw first
    max_objects anchors (boxes, scores, class_ids), as the original trainer
    evaluates, or with cfg.eval_with_nms real detections (confidence filter
    + class-agnostic NMS, the NMS kernel on the card; empty slots get
    class_id -1, which the evaluator never matches).

    group: the data axis's process group; the loss parts are then the
    global batch's, the predictions this rank's rows'. shard_text: as in
    `make_train_step` (the class ids come out global)."""
    weights = dict(cfg.loss_weights)
    M = cfg.max_objects

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Dict[str, torch.Tensor],
                  text: torch.Tensor):
        model = state.model.eval()
        shard = shard_text(text) if shard_text is not None else None
        kw = {} if shard is None else {'class_shard': shard}
        with _autocast(cfg, batch['images'].device):
            outputs = functional_call(model, state.eval_params(),
                                      (batch['images'], text), kw)
        _, parts = combined_loss_compat(
            outputs, batch, weights, temperature=cfg.temperature,
            iou_type=cfg.iou_type, label_smoothing=cfg.label_smoothing,
            group=group, class_shard=shard)
        parts = _mean_parts({k: v for k, v in parts.items()
                             if k != 'dfl_loss'}, group)
        if cfg.eval_with_nms:
            det = batched_nms(outputs['boxes'], outputs['scores'],
                              outputs['class_ids'], cfg.eval_conf_threshold,
                              cfg.eval_iou_threshold,
                              topk=min(1024, outputs['scores'].shape[1]),
                              max_detections=M)
            preds = {k: det[k] for k in ('boxes', 'scores', 'class_ids')}
        else:
            preds = {k: outputs[k][:, :M]
                     for k in ('boxes', 'scores', 'class_ids')}
        return parts, preds

    return eval_step
