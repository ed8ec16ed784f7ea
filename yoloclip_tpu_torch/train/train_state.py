"""Train state, optimizer, schedule and the train / eval steps. Counterpart
of `yoloclip_tpu/train/train_state.py`.

  * The optimizer is torch's AdamW (or SGD with momentum 0.9 as foreach
    ops, `CapturableSGD`), the math of optax's: eps outside the square
    root, decoupled weight decay on every parameter, BatchNorm's affine
    included. On CUDA it is capturable, so a step runs as a CUDA graph
    (the trainer's programs), with the learning rate a 0-d fp32 device
    tensor, as optax's `inject_hyperparams` holds it in float32 (torch
    refuses `capturable=True` on the CPU, where the rate stays a float).
    A loaded optimizer state takes the same form, whatever device or
    trainer saved it (`load_optimizer_state`).
  * The learning rate is the original repo's OneCycle curve
    (`make_onecycle_schedule`), written into the optimizer's param groups
    by the trainer in epoch or step units; counts past the end clamp to
    the final rate (torch's `OneCycleLR` raises there).
  * EMA of the parameters only, decay ramped as
    decay * (1 - exp(-(step + 1) / warmup)), computed on the host from the
    host step count and passed to the step's device work as a 0-d fp32
    tensor (an input of the train program, never part of its key);
    evaluation runs the EMA parameters with the model's current BatchNorm
    buffers.
  * Gradient accumulation splits the batch into equal micro-batches: the
    BatchNorm statistics update once per micro-batch, in order, and the
    gradients and loss parts average over them.
  * bf16 computes the forward under `torch.autocast` (convs, linears and
    matmuls in bf16, weights cast at use, never cached: a cast cached at
    a capture would be a stale copy on replay); the parameters,
    gradients, optimizer state, EMA and every loss stay fp32.
  * `make_train_step(cfg, programs=...)` / `make_eval_step(cfg,
    programs=...)` run the step's device work as a program of a
    `ProgramCache` (`inference/program.py`), keyed on the state by
    identity and the step's static settings, as the JAX trainer jits
    them; without `programs` the same body runs eagerly.
  * Data parallelism (`parallel/train_step.py`): the losses normalise over
    the global batch, BatchNorm over the global statistics, and the
    returned loss parts are the global batch's (averaged over the ranks),
    as the JAX package's sharded step returns them. The gradients are
    averaged over the ranks after the last micro-batch's backward, by
    `collectives.all_reduce_gradients` in the bare body (the programs: on
    the card CUDA graphs holding NCCL's collectives, as JAX jits the
    sharded step) or by a DistributedDataParallel wrapper of the model
    (`ddp=`, the eager route, with no all-reduce on all but the last
    micro-batch), the same average bit for bit on two ranks.
  * Class parallelism (the 'model' axis): the text is the rank's block of
    the classes (`shard_text` gives its `ClassShard`, outside the body:
    it exchanges the blocks' sizes on the host), which the model and the
    losses merge over the model group.
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn
from torch.func import functional_call

from yoloclip_tpu_torch.config import TrainingConfig
from yoloclip_tpu_torch.inference.program import nms_key
from yoloclip_tpu_torch.ops.nms import batched_nms
from yoloclip_tpu_torch.parallel.collectives import (all_reduce_gradients,
                                                     group_mean)
from yoloclip_tpu_torch.train.assign import anchor_points
from yoloclip_tpu_torch.train.losses import (combined_loss_clean,
                                             combined_loss_compat)

TRAIN_KEYS = ('loss', 'contrastive_loss', 'iou_loss', 'dfl_loss')
BATCH_KEYS = ('images', 'boxes', 'class_ids', 'valid_mask')


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


class CapturableSGD(torch.optim.SGD):
    """torch's SGD with momentum, its step as foreach ops that take the
    rate as it is, a float or a 0-d device tensor: torch's own SGD reads
    a tensor rate back to the host, which a capture refuses. optax's
    update: trace = g + momentum * trace (trace starting at g),
    p -= lr * trace. No dampening, Nesterov or weight decay, as
    `make_optimizer` builds it."""

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params = [p for p in group['params'] if p.grad is not None]
            grads = [p.grad for p in params]
            bufs = [self.state[p].get('momentum_buffer') for p in params]
            if any(b is None for b in bufs):   # the first step, eager
                bufs = [g.detach().clone() for g in grads]
                for p, b in zip(params, bufs):
                    self.state[p]['momentum_buffer'] = b
            else:
                torch._foreach_mul_(bufs, group['momentum'])
                torch._foreach_add_(bufs, grads)
            torch._foreach_sub_(params, torch._foreach_mul(bufs,
                                                           group['lr']))


def _capturable(device: torch.device) -> bool:
    """Whether an optimizer over parameters on `device` is capturable:
    torch refuses `capturable=True` on the CPU."""
    return device.type == 'cuda'


def _device_form(optimizer: torch.optim.Optimizer, rates=()) -> None:
    """Put `optimizer` in the form of its parameters' device, as a fresh
    `make_optimizer` builds it and a loaded state dict may not (its group
    fields and step counters are whatever device or trainer saved them).
    Capturable: each group's rate a 0-d fp32 device tensor (`rates`' own,
    where given, refilled), the capturable flag on and AdamW's step
    counters fp32 on the device. Else: the rate a float, the flag off and
    the step counters CPU tensors."""
    for i, group in enumerate(optimizer.param_groups):
        device = group['params'][0].device
        capturable = _capturable(device)
        lr = float(group['lr'])
        if capturable:
            rate = rates[i] if i < len(rates) else None
            if not isinstance(rate, torch.Tensor):
                rate = torch.empty((), dtype=torch.float32, device=device)
            group['lr'] = rate.fill_(lr)
        else:
            group['lr'] = lr
        if 'capturable' in group:     # AdamW's; CapturableSGD has none
            group['capturable'] = capturable
        for p in group['params']:
            step = optimizer.state.get(p, {}).get('step')
            if isinstance(step, torch.Tensor):
                optimizer.state[p]['step'] = (
                    step.to(device, torch.float32) if capturable
                    else step.to('cpu'))


def make_optimizer(cfg: TrainingConfig, params) -> torch.optim.Optimizer:
    """AdamW (betas 0.9/0.999, eps 1e-8, decoupled decay on every
    parameter) or SGD with momentum 0.9, at cfg.learning_rate, in the
    form of the parameters' device (`_device_form`): on CUDA the step is
    capturable and reads its rate from a 0-d fp32 device tensor, as
    optax's `inject_hyperparams` holds it; on the CPU the rate is a
    float."""
    params = list(params)
    if cfg.optimizer_type.lower() == 'adamw':
        opt = torch.optim.AdamW(params, lr=cfg.learning_rate,
                                betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=cfg.weight_decay)
    elif cfg.optimizer_type.lower() == 'sgd':
        opt = CapturableSGD(params, lr=cfg.learning_rate, momentum=0.9)
    else:
        raise ValueError(f'Unknown optimizer {cfg.optimizer_type}')
    _device_form(opt)
    return opt


def set_learning_rate(state: TrainState, lr: float) -> None:
    """Write the rate in the optimizer's form: in place into a capturable
    optimizer's device tensor (a fill on the current stream, no sync; the
    programs read it on replay), else into the param groups."""
    for group in state.optimizer.param_groups:
        if isinstance(group['lr'], torch.Tensor):
            group['lr'].fill_(float(lr))
        else:
            group['lr'] = float(lr)


def get_learning_rate(state: TrainState) -> float:
    return float(state.optimizer.param_groups[0]['lr'])


def load_optimizer_state(state: TrainState, saved: Dict) -> None:
    """`optimizer.load_state_dict(saved)`, then the form of the
    optimizer's device (`_device_form`), keeping a capturable optimizer's
    own rate tensors: load_state_dict takes every group field but the
    parameters from `saved`, the rate and the capturable flag included,
    and places AdamW's step counters by the saved flag, so a checkpoint
    of another device or of an older trainer (a float rate, capturable
    off) would otherwise leave the optimizer in that form."""
    rates = [g['lr'] for g in state.optimizer.param_groups]
    state.optimizer.load_state_dict(saved)
    _device_form(state.optimizer, rates)


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
                          enabled=cfg.model.dtype == 'bfloat16',
                          cache_enabled=False)


def _ema_decay(cfg: TrainingConfig, step: int) -> float:
    """The EMA decay of optimizer step `step` (0-based)."""
    warmup = max(float(cfg.ema_warmup_steps), 1.0)
    return cfg.ema_decay * (1 - math.exp(-(step + 1) / warmup))


def _mean_parts(parts: Dict[str, torch.Tensor], group
                ) -> Dict[str, torch.Tensor]:
    """Each rank's loss parts -> the global batch's, in one all-reduce."""
    if group is None:
        return parts
    keys = list(parts)
    vals = group_mean(torch.stack([parts[k] for k in keys]), group)
    return dict(zip(keys, vals.unbind(0)))


def _agreed(name: str, settings: tuple, arrays) -> tuple:
    """What every rank of a sharded step's program must pass equal
    (`inference/program.py::KeyAgreement`): the step, its settings and
    the batch's shapes and dtypes. The text is left out: under a model
    axis its class blocks differ by rank by design, and its shape changes
    no collective (they reduce the classes to one slot, or run on the
    BatchNorm statistics, the normalisers and the gradients)."""
    return (name,) + settings + tuple((tuple(x.shape), str(x.dtype))
                                      for x in arrays)


def make_train_step(cfg: TrainingConfig, ddp=None, group=None,
                    shard_text: Optional[Callable] = None,
                    programs=None, grad_group=None):
    """train_step(state, batch, text) -> loss parts (0-d fp32 tensors on
    the device). Updates the state in place: BatchNorm buffers, parameters
    (one optimizer step at the lr in the param groups), EMA and step.

    batch: images (B, H, W, 3) float [0, 1], boxes (B, M, 4), class_ids
    (B, M), valid_mask (B, M), tensors on the model's device. text:
    (B, C, E) per sample (zero-padded vocabularies) or (C, E) shared.

    programs: a `ProgramCache`; the step's device work (the micro-batch
    loop, backward, the gradient all-reduce, the optimizer step, the EMA)
    then runs as its 'train_step' program, keyed on the state by
    identity, the class shard, the assigner, the accumulation, the
    compute dtype and whether the EMA is tracked, with the EMA decay an
    input and the rate read from the optimizer's device tensor, so neither
    enters the key. The host parts stay outside it: the decay, the class
    shard, `state.step`. On CUDA the captured backward allocates the
    gradients in the graph pool, so after a replay `p.grad` need not hold
    that step's gradients (a later capture of another train program
    re-binds them); read gradients from the eager step (no `programs`),
    as the JAX package's jitted step exposes none.

    group (`parallel/train_step.py::make_sharded_train_step`): the data
    axis's process group; the batch is then this rank's rows, laid out so
    that its micro-batch i is its share of the global micro-batch i. The
    body averages the gradients over grad_group (default: group) once,
    after the last backward (`collectives.all_reduce_gradients`), unless
    ddp, a DistributedDataParallel wrapper of state.model, runs the
    forward and averages them itself (the eager route, never a program:
    DDP's reducer cannot be captured). A program over a group needs
    collectives a CUDA graph can hold (NCCL on the card; any backend on
    the CPU, where a program runs its body without capture;
    `make_sharded_train_step` refuses gloo on CUDA). With a cache that has
    an agreement, every rank must call with the same settings and batch
    shapes (`train_step.agreed(batch)`; mismatches raise on every rank).
    shard_text: text -> its ClassShard, when the text is this rank's
    block of the classes (a mesh with a model axis)."""
    weights = dict(cfg.loss_weights)
    accum = max(int(cfg.grad_accum_steps), 1)
    settings = (cfg.assigner, accum, cfg.model.dtype, cfg.ema_decay > 0)
    reduce_group = group if grad_group is None else grad_group
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

    def body(state: TrainState, shard, images, boxes, class_ids,
             valid_mask, text, decay=None) -> Dict[str, torch.Tensor]:
        """The step's device work; shard: the text's ClassShard (None:
        every class); decay: the EMA decay, a 0-d fp32 tensor on the
        device (None: no EMA)."""
        b, rest = divmod(images.shape[0], accum)
        if rest:
            raise ValueError(f'batch size {images.shape[0]} not divisible '
                             f'by grad_accum_steps {accum}')
        model = state.model.train()
        forward = model if ddp is None else ddp
        state.optimizer.zero_grad(set_to_none=True)
        batch = {'images': images, 'boxes': boxes, 'class_ids': class_ids,
                 'valid_mask': valid_mask}
        kw = {} if shard is None else {'class_shard': shard}
        parts_sum: Dict[str, torch.Tensor] = {}
        for i in range(accum):
            sl = slice(i * b, (i + 1) * b)
            mb = {k: v[sl] for k, v in batch.items()}
            tx = text[sl] if text.dim() == 3 else text
            # DDP all-reduces the gradients on the last micro-batch only
            with (ddp.no_sync() if ddp is not None and i < accum - 1
                  else contextlib.nullcontext()):
                with _autocast(cfg, images.device):
                    outputs = forward(mb['images'], tx, **kw)
                total, parts = compute_loss(outputs, mb, shard)
                (total / accum if accum > 1 else total).backward()
            for k, v in parts.items():
                v = v.detach()
                parts_sum[k] = v if k not in parts_sum else parts_sum[k] + v
        if ddp is None:
            all_reduce_gradients(model.parameters(), reduce_group)
        state.optimizer.step()
        if decay is not None:
            ema = list(state.ema.values())
            params = [p.detach() for p in model.parameters()]
            torch._foreach_mul_(ema, decay)
            torch._foreach_add_(ema, torch._foreach_mul(params, 1 - decay))
        if accum > 1:
            parts_sum = {k: v / accum for k, v in parts_sum.items()}
        return _mean_parts(parts_sum, group)

    def agreed(batch: Dict[str, torch.Tensor]) -> tuple:
        return _agreed('train_step', settings,
                       [batch[k] for k in BATCH_KEYS])

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   text: torch.Tensor) -> Dict[str, torch.Tensor]:
        inputs = [batch[k] for k in BATCH_KEYS] + [text]
        device = batch['images'].device
        shard = shard_text(text) if shard_text is not None else None
        if state.ema is not None:
            decay = torch.tensor(_ema_decay(cfg, state.step),
                                 dtype=torch.float32)
            # pinned: its copy to the card does not wait for the device
            inputs.append(decay.pin_memory() if device.type == 'cuda'
                          else decay)
        if programs is None:
            parts = body(state, shard, *(x.to(device, non_blocking=True)
                                         for x in inputs))
        else:
            parts = programs.run('train_step', (state, shard) + settings,
                                 functools.partial(body, state, shard),
                                 inputs, device, grad=True,
                                 agreed=agreed(batch))
        state.step += 1
        return parts

    train_step.agreed = agreed
    return train_step


def make_eval_step(cfg: TrainingConfig, group=None,
                   shard_text: Optional[Callable] = None, programs=None):
    """eval_step(state, batch, text) -> (loss parts without DFL, preds).

    The model runs in eval mode with `state.eval_params()` (EMA when
    tracked) and its current BatchNorm buffers. preds: the raw first
    max_objects anchors (boxes, scores, class_ids), as the original trainer
    evaluates, or with cfg.eval_with_nms real detections (confidence filter
    + class-agnostic NMS, the NMS kernel on the card; empty slots get
    class_id -1, which the evaluator never matches).

    group: the data axis's process group; the loss parts are then the
    global batch's, the predictions this rank's rows'. shard_text: as in
    `make_train_step` (the class ids come out global). programs: a
    `ProgramCache`; the step then runs as its 'eval_step' program, keyed
    on the state by identity, the class shard, the compute dtype,
    max_objects and the NMS settings (`inference/program.py::nms_key`, as
    the detection programs key them), over a group on the terms of
    `make_train_step`'s programs (`eval_step.agreed(batch)`)."""
    weights = dict(cfg.loss_weights)
    M = cfg.max_objects
    settings = (cfg.model.dtype, M, cfg.eval_with_nms) + (
        nms_key({'conf_threshold': float(cfg.eval_conf_threshold),
                 'iou_threshold': float(cfg.eval_iou_threshold)})
        if cfg.eval_with_nms else ())

    @torch.no_grad()
    def body(state: TrainState, shard, images, boxes, class_ids,
             valid_mask, text):
        model = state.model.eval()
        batch = {'images': images, 'boxes': boxes, 'class_ids': class_ids,
                 'valid_mask': valid_mask}
        kw = {} if shard is None else {'class_shard': shard}
        with _autocast(cfg, images.device):
            outputs = functional_call(model, state.eval_params(),
                                      (images, text), kw)
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

    def agreed(batch: Dict[str, torch.Tensor]) -> tuple:
        return _agreed('eval_step', settings, [batch[k] for k in BATCH_KEYS])

    def eval_step(state: TrainState, batch: Dict[str, torch.Tensor],
                  text: torch.Tensor):
        inputs = [batch[k] for k in BATCH_KEYS] + [text]
        shard = shard_text(text) if shard_text is not None else None
        if programs is None:
            return body(state, shard, *inputs)
        return programs.run('eval_step', (state, shard) + settings,
                            functools.partial(body, state, shard), inputs,
                            batch['images'].device, agreed=agreed(batch))

    eval_step.agreed = agreed
    return eval_step
