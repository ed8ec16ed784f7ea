"""Training runtime: epoch loop, eval cadence, checkpoints, recovery.
Counterpart of `yoloclip_tpu/train/trainer.py`.

  * per-epoch train loop; the loss parts accumulate ON THE DEVICE and come
    to the host once per epoch (a `.item()` a step would sync the card);
  * evaluation every `eval_interval` epochs: losses + mAP over the raw
    first max_objects predictions (or NMS'ed detections with
    cfg.eval_with_nms);
  * the learning rate from the OneCycle curve, once per epoch ('epoch'
    units, the original trainer's cadence) or per step ('step');
  * best-by-mAP50-95, interval and final checkpoints (`.pt` files,
    `utils/checkpoint.py`; the best and interval ones written in the
    background, as the JAX trainer's async saves), a crash checkpoint and
    the CONTINUE_ON_ERROR environment gate; `history.json` written
    atomically every epoch;
  * prompts encoded per sample through the text encoder's per-prompt cache
    and zero-padded to a power-of-two class bucket of at least 8, with no
    class mask (the original zero-pads without masking);
  * the train and eval steps run as programs (`self.programs`, CUDA
    graphs on the card, `inference/program.py`), one a key where the JAX
    trainer's jitted `_train_step` / `_eval_step` trace: the batch's and
    the text bucket's shapes and dtypes, the step's static settings and
    the state by identity; the learning rate and the EMA decay are inputs.
    `load()` drops them (it replaces the optimizer's and the EMA's
    tensors). `_train_step_eager` / `_eval_step_eager` run the same bodies
    eagerly, for readings beside the programs (under a mesh, the train
    step through DistributedDataParallel).

`mesh=` (`parallel/mesh.py`, one process per mesh cell): the sharded
step of `parallel/train_step.py`. Each rank takes its rows of the global
batch (or, with `mesh.local_batches`, its loader yields them) and, with a
'model' axis, its block of the classes; the class bucket is the global
batch's (an all-reduced MAX: the padded columns enter the contrastive
softmax, and a block may hold padding only); `evaluate` merges the class
ids over the model axis and gathers every data rank's predictions and
targets on the host, so each rank computes the same global mAP and takes
the same best-checkpoint decision; process 0 alone writes checkpoints and
`history.json` (every rank holds the same state), the others wait at a
barrier. The sharded steps are programs too (`make_sharded_train_step`,
`make_sharded_eval_step`; on the card CUDA graphs holding NCCL's
collectives), their ranks agreeing on each call's key: the digest of the
step's key rides on the class bucket's exchange, so the check adds no
round trip, and keys that differ (e.g. a partial last batch of other
sizes under `mesh.local_batches`) raise on every rank. Over gloo on the
card (ranks sharing one device) nothing can be captured: the trainer then
runs the eager route, DistributedDataParallel, and logs why once.
`self.model` stays the bare module, so checkpoints carry no `module.`
prefix and `load` works on every rank. TrainingConfig.data_parallel is
read by nothing, as in the JAX package: the mesh sets the parallelism.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from yoloclip_tpu_torch.config import TrainingConfig
from yoloclip_tpu_torch.inference.program import ProgramCache
from yoloclip_tpu_torch.parallel.collectives import group_max
from yoloclip_tpu_torch.train.train_state import (BATCH_KEYS, TRAIN_KEYS,
                                                  TrainState,
                                                  create_train_state,
                                                  get_learning_rate,
                                                  load_optimizer_state,
                                                  make_eval_step,
                                                  make_onecycle_schedule,
                                                  make_train_step,
                                                  set_learning_rate)
from yoloclip_tpu_torch.utils.checkpoint import (CheckpointWriteError,
                                                 finish_async_saves,
                                                 load_checkpoint,
                                                 save_checkpoint)
from yoloclip_tpu_torch.utils.metrics import calculate_map

logger = logging.getLogger(__name__)

EVAL_KEYS = ('loss', 'contrastive_loss', 'iou_loss')


def _bucket_classes(n: int, minimum: int = 8) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


def _host_means(totals: Optional[Dict[str, torch.Tensor]], keys,
                n: int) -> Dict[str, float]:
    """Device sums -> host means, in ONE device-to-host copy."""
    if totals is None:
        return {k: 0.0 for k in keys}
    vals = torch.stack([totals[k] for k in keys]).cpu().tolist()
    return {k: v / n for k, v in zip(keys, vals)}


class YOLOCLIPTrainer:
    def __init__(self, model, text_encoder, cfg: TrainingConfig,
                 state: Optional[TrainState] = None, mesh=None,
                 device='cuda', schedule_units: str = 'epoch'):
        """model: a YOLOCLIP with fp32 weights; text_encoder: callable
        list[str] -> (n, E) tensor (`text/encoder.py::CLIPTextEncoder`).
        device: where training runs ('cuda' unless the caller asks for the
        CPU; under a mesh, this rank's device on it). schedule_units:
        'epoch' or 'step'."""
        if schedule_units not in ('epoch', 'step'):
            raise ValueError(f"schedule_units must be 'epoch' or 'step', "
                             f'got {schedule_units!r}')
        self.cfg = cfg
        self.mesh = mesh
        self.device = torch.device(device if mesh is None
                                   else mesh.local_device)
        self.text_encoder = text_encoder
        self.output_dir = cfg.output_dir
        os.makedirs(self.output_dir, exist_ok=True)
        self.state = state or create_train_state(model, cfg, self.device)
        self.schedule_units = schedule_units
        self._schedule = None   # built once steps_per_epoch is known
        # the train and eval programs
        self.programs = ProgramCache()
        if mesh is not None:
            from yoloclip_tpu_torch.parallel import train_step as ps
            self.state = ps.replicate_state(self.state, mesh)
            self._train_step_eager = ps.make_sharded_train_step(
                cfg, mesh, eager=True)(self.state)
            self._eval_step_eager = ps.make_sharded_eval_step(cfg, mesh,
                                                              eager=True)
            reason = ps.sharded_step_blocker(mesh)
            if reason is None:
                if mesh.multiprocess:
                    self.programs = ps.sharded_programs(mesh)
                self._train_step = ps.make_sharded_train_step(
                    cfg, mesh, programs=self.programs)(self.state)
                self._eval_step = ps.make_sharded_eval_step(
                    cfg, mesh, programs=self.programs)
            else:
                logger.warning('the sharded train and eval steps run '
                               'eagerly on %s: %s', self.device, reason)
                self._train_step = self._train_step_eager
                self._eval_step = self._eval_step_eager
        else:
            self._train_step = make_train_step(cfg, programs=self.programs)
            self._train_step_eager = make_train_step(cfg)
            self._eval_step = make_eval_step(cfg, programs=self.programs)
            self._eval_step_eager = make_eval_step(cfg)
        self.model = self.state.model
        self.best_map = 0.0

    @property
    def _group(self):
        return None if self.mesh is None else self.mesh.group

    @property
    def _rank(self) -> int:
        """This process's rank in the world (the writer is 0)."""
        return 0 if self.mesh is None else self.mesh.process_index

    def _barrier(self) -> None:
        if self._group is not None:
            torch.distributed.barrier(group=self.mesh.host_group)

    # ------------------------------------------------------------------
    def _encode_batch_text(self, text_prompts: List[List[str]],
                           agreed: Optional[tuple] = None) -> torch.Tensor:
        """Per-sample prompt lists -> (B, Cb, E) on the device, zero-padded
        to the class bucket; under a model axis this rank's block of the
        Cb classes. agreed: the key of the step this text is for
        (`train_step.agreed(batch)`); under a mesh its digest rides on the
        bucket's exchange, for the programs' agreement to read."""
        dtype = next(self.model.parameters()).dtype   # fp32 master weights
        rows = [self.text_encoder(list(p)).to(self.device, dtype)
                for p in text_prompts]
        cmax = _bucket_classes(max(r.shape[0] for r in rows))
        if self._group is not None:   # the global batch's bucket
            if agreed is not None:
                (cmax,) = self.programs.agreement.exchange(agreed, [cmax])
            else:
                cmax = int(group_max(torch.tensor([cmax]),
                                     self.mesh.host_group)[0])
        out = torch.zeros((len(rows), cmax, rows[0].shape[1]),
                          dtype=dtype, device=self.device)
        for i, r in enumerate(rows):
            out[i, :r.shape[0]] = r
        if self.mesh is not None:
            out = out.narrow(1, *self.mesh.class_block(cmax))
        return out

    def _agreed(self, step, arrays: Dict) -> Optional[tuple]:
        """The key the programs' agreement checks for step(batch) (None
        without one: one device, or the eager route)."""
        if self.programs.agreement is None:
            return None
        return step.agreed(arrays)

    def _local(self, batch: Dict, accum: int = 1) -> Dict:
        """This process's rows of a batch: the batch itself on one device
        or where each rank loads its own shard, else its rows of the global
        batch, laid out for `accum` micro-batches."""
        if self._group is None or self.mesh.local_batches:
            return batch
        from yoloclip_tpu_torch.parallel.train_step import place_batch
        keys = BATCH_KEYS + ('text_prompts',)
        return place_batch({k: batch[k] for k in keys}, self.mesh, accum)

    def _put_batch(self, batch: Dict) -> Dict[str, torch.Tensor]:
        """The batch's arrays as tensors on the device (no copy for those
        already there, e.g. from `data.loader.device_prefetch`); the images
        in the master weights' dtype."""
        out = {k: torch.as_tensor(batch[k]).to(self.device,
                                               non_blocking=True)
               for k in BATCH_KEYS}
        out['images'] = out['images'].to(next(self.model.parameters()).dtype)
        return out

    # ------------------------------------------------------------------
    def train_epoch(self, dataloader, epoch: int) -> Dict[str, float]:
        if self._schedule is None:
            total = self.cfg.max_epochs * len(dataloader)
            warm = self.cfg.warmup_epochs * len(dataloader)
            self._schedule = make_onecycle_schedule(self.cfg.learning_rate,
                                                    total, warm)
        if self.schedule_units == 'epoch':
            set_learning_rate(self.state, self._schedule(epoch - 1))
        n, totals = 0, None
        for batch in dataloader:
            if self.schedule_units == 'step':
                set_learning_rate(self.state,
                                  self._schedule(self.state.step))
            batch = self._local(batch, max(int(self.cfg.grad_accum_steps),
                                           1))
            arrays = self._put_batch(batch)
            text = self._encode_batch_text(
                batch['text_prompts'], self._agreed(self._train_step, arrays))
            parts = self._train_step(self.state, arrays, text)
            n += 1
            totals = ({k: parts[k] for k in TRAIN_KEYS} if totals is None
                      else {k: totals[k] + parts[k] for k in TRAIN_KEYS})
        return _host_means(totals, TRAIN_KEYS, n)

    def evaluate(self, dataloader, epoch: int = 0) -> Dict[str, float]:
        preds_all, targets_all = [], []
        n, totals = 0, None
        for batch in dataloader:
            batch = self._local(batch)
            arrays = self._put_batch(batch)
            text = self._encode_batch_text(
                batch['text_prompts'], self._agreed(self._eval_step, arrays))
            parts, preds = self._eval_step(self.state, arrays, text)
            n += 1
            totals = ({k: parts[k] for k in EVAL_KEYS} if totals is None
                      else {k: totals[k] + parts[k] for k in EVAL_KEYS})
            preds = {k: v.cpu().numpy() for k, v in preds.items()}
            targets = {k: np.asarray(torch.as_tensor(batch[k]).cpu())
                       for k in ('boxes', 'class_ids', 'valid_mask')}
            if self._group is not None:
                # every rank's rows, in rank order, on every rank (the JAX
                # trainer's process_allgather): the same global mAP and
                # best-checkpoint decision everywhere
                preds, targets = self._gather_host(preds, targets)
            preds_all.append(preds)
            targets_all.append(targets)
        map50, map50_95 = calculate_map(preds_all, targets_all)
        out = _host_means(totals, EVAL_KEYS, n)
        out.update({'mAP50': map50, 'mAP50_95': map50_95})
        return out

    def _gather_host(self, *dicts):
        """Each dict of numpy arrays concatenated over the data ranks (rank
        order) on every rank, through the host group of the data axis."""
        group = self.mesh.host_data_group
        got = [None] * torch.distributed.get_world_size(group)
        torch.distributed.all_gather_object(got, dicts, group=group)
        return tuple({k: np.concatenate([g[i][k] for g in got])
                      for k in d} for i, d in enumerate(dicts))

    # ------------------------------------------------------------------
    def train(self, train_dataloader, val_dataloader=None,
              callbacks: Optional[List[Callable]] = None
              ) -> Dict[str, List[float]]:
        cfg = self.cfg
        history = {'train_loss': [], 'val_loss': [], 'val_mAP50': [],
                   'val_mAP50_95': [], 'learning_rate': []}
        for epoch in range(1, cfg.max_epochs + 1):
            try:
                t0 = time.time()
                train_metrics = self.train_epoch(train_dataloader, epoch)
                val_metrics = None
                if (val_dataloader is not None
                        and epoch % cfg.eval_interval == 0):
                    val_metrics = self.evaluate(val_dataloader, epoch)
                    if val_metrics['mAP50_95'] > self.best_map:
                        self.best_map = val_metrics['mAP50_95']
                        # mid-training saves do not wait: the next epoch
                        # runs while the file is written
                        self.save(os.path.join(self.output_dir,
                                               'best_model.pt'), wait=False)
                    history['val_loss'].append(val_metrics['loss'])
                    history['val_mAP50'].append(val_metrics['mAP50'])
                    history['val_mAP50_95'].append(val_metrics['mAP50_95'])
                history['train_loss'].append(train_metrics['loss'])
                history['learning_rate'].append(
                    get_learning_rate(self.state))
                logger.info(
                    'Epoch %d: train loss %.4f%s (%.1fs)', epoch,
                    train_metrics['loss'],
                    '' if val_metrics is None else
                    f", val loss {val_metrics['loss']:.4f}, "
                    f"mAP50 {val_metrics['mAP50']:.4f}, "
                    f"mAP50-95 {val_metrics['mAP50_95']:.4f}",
                    time.time() - t0)
                if epoch % cfg.save_interval == 0:
                    self.save(os.path.join(self.output_dir,
                                           f'checkpoint_epoch_{epoch}.pt'),
                              wait=False)
                for cb in callbacks or []:
                    cb(epoch, train_metrics, val_metrics)
                self._save_history(history)
            except Exception as e:   # crash checkpoint + env-gated resume
                if isinstance(e, CheckpointWriteError):
                    raise      # a lost checkpoint is no epoch to skip
                logger.exception('Error during training epoch %d: %s',
                                 epoch, e)
                try:
                    self.save(os.path.join(
                        self.output_dir, f'error_checkpoint_epoch_{epoch}.pt'))
                except Exception:
                    logger.exception('Failed to save crash checkpoint')
                if os.environ.get('CONTINUE_ON_ERROR', '0') != '1':
                    logger.error('Training stopped due to error.')
                    break
                continue
        self.save(os.path.join(self.output_dir, 'final_model.pt'))
        self._finish_saves()
        return history

    def _save_history(self, history: Dict[str, List[float]]) -> None:
        """`history.json` after every epoch (atomic rename), so a crash
        keeps the curves as the crash checkpoint keeps the weights. One
        writer under a mesh: rank 0."""
        if self._rank != 0:
            return
        path = os.path.join(self.output_dir, 'history.json')
        tmp = path + '.tmp'
        with open(tmp, 'w') as f:
            json.dump(history, f, indent=2)
        os.replace(tmp, path)

    # ------------------------------------------------------------------
    def save(self, path: str, wait: bool = True) -> None:
        """The model's state dict, the EMA (when tracked, so inference
        loaders serve it), the optimizer state, step and best_map.
        wait=False returns once the state is snapshotted and writes the
        file in the background (`utils/checkpoint.py`; the next step may
        run at once). Under a mesh rank 0 writes (every rank holds the same
        state) and the others wait at a barrier until it has started."""
        if self._rank == 0:
            save_checkpoint(path, self.model.state_dict(),
                            ema=self.state.ema,
                            optimizer_state=self.state.optimizer.state_dict(),
                            step=self.state.step,
                            metadata={'best_map': self.best_map}, wait=wait)
            logger.info('Checkpoint save %s to %s',
                        'complete' if wait else 'running (async)', path)
        self._barrier()

    def _finish_saves(self) -> None:
        """Every save written (its failure raised) before any rank goes on:
        no rank reads a file rank 0 is still writing."""
        finish_async_saves()
        self._barrier()

    def load(self, path: str) -> None:
        """Resume: weights, BatchNorm buffers, optimizer, step, EMA and
        best_map (every rank reads the file, after every save is written).
        Drops the programs: they captured the optimizer's state and EMA
        tensors this replaces."""
        self._finish_saves()
        ckpt = load_checkpoint(path)
        self.programs.clear()
        self.model.load_state_dict(ckpt['model'])
        if self.state.ema is not None:
            ema = ckpt.get('ema')
            # a checkpoint without EMA restarts the average from the
            # restored weights
            src = ema if ema is not None else dict(
                self.model.named_parameters())
            self.state.ema = {k: src[k].detach().to(p.device).clone()
                              for k, p in self.model.named_parameters()}
        if ckpt.get('optimizer') is not None:
            load_optimizer_state(self.state, ckpt['optimizer'])
        self.state.step = int(ckpt.get('step', 0))
        self.best_map = (ckpt.get('metadata') or {}).get('best_map', 0.0)
        logger.info('Checkpoint loaded from %s', path)
