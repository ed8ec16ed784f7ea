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
    `utils/checkpoint.py`), a crash checkpoint and the CONTINUE_ON_ERROR
    environment gate; `history.json` written atomically every epoch;
  * prompts encoded per sample through the text encoder's per-prompt cache
    and zero-padded to a power-of-two class bucket of at least 8, with no
    class mask (the original zero-pads without masking).
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
from yoloclip_tpu_torch.train.train_state import (TRAIN_KEYS, TrainState,
                                                  create_train_state,
                                                  get_learning_rate,
                                                  make_eval_step,
                                                  make_onecycle_schedule,
                                                  make_train_step,
                                                  set_learning_rate)
from yoloclip_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                 save_checkpoint)
from yoloclip_tpu_torch.utils.metrics import calculate_map

logger = logging.getLogger(__name__)

EVAL_KEYS = ('loss', 'contrastive_loss', 'iou_loss')
BATCH_KEYS = ('images', 'boxes', 'class_ids', 'valid_mask')


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
        CPU). schedule_units: 'epoch' or 'step'."""
        if mesh is not None or cfg.data_parallel > 1:
            raise NotImplementedError(
                'data-parallel training is not ported yet (ROADMAP.md, '
                'queue A item 5: multi-device)')
        if schedule_units not in ('epoch', 'step'):
            raise ValueError(f"schedule_units must be 'epoch' or 'step', "
                             f'got {schedule_units!r}')
        self.cfg = cfg
        self.device = torch.device(device)
        self.text_encoder = text_encoder
        self.output_dir = cfg.output_dir
        os.makedirs(self.output_dir, exist_ok=True)
        self.state = state or create_train_state(model, cfg, self.device)
        self.model = self.state.model
        self.schedule_units = schedule_units
        self._schedule = None   # built once steps_per_epoch is known
        self._train_step = make_train_step(cfg)
        self._eval_step = make_eval_step(cfg)
        self.best_map = 0.0

    # ------------------------------------------------------------------
    def _encode_batch_text(self, text_prompts: List[List[str]]
                           ) -> torch.Tensor:
        """Per-sample prompt lists -> (B, Cb, E) on the device, zero-padded
        to the class bucket."""
        rows = [self.text_encoder(list(p)).to(self.device, torch.float32)
                for p in text_prompts]
        cmax = _bucket_classes(max(r.shape[0] for r in rows))
        out = torch.zeros((len(rows), cmax, rows[0].shape[1]),
                          dtype=torch.float32, device=self.device)
        for i, r in enumerate(rows):
            out[i, :r.shape[0]] = r
        return out

    def _put_batch(self, batch: Dict) -> Dict[str, torch.Tensor]:
        """The batch's arrays as tensors on the device (no copy for those
        already there, e.g. from `data.loader.device_prefetch`)."""
        return {k: torch.as_tensor(batch[k]).to(self.device,
                                                non_blocking=True)
                for k in BATCH_KEYS}

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
            text = self._encode_batch_text(batch['text_prompts'])
            parts = self._train_step(self.state, self._put_batch(batch),
                                     text)
            n += 1
            totals = ({k: parts[k] for k in TRAIN_KEYS} if totals is None
                      else {k: totals[k] + parts[k] for k in TRAIN_KEYS})
        return _host_means(totals, TRAIN_KEYS, n)

    def evaluate(self, dataloader, epoch: int = 0) -> Dict[str, float]:
        preds_all, targets_all = [], []
        n, totals = 0, None
        for batch in dataloader:
            text = self._encode_batch_text(batch['text_prompts'])
            arrays = self._put_batch(batch)
            parts, preds = self._eval_step(self.state, arrays, text)
            n += 1
            totals = ({k: parts[k] for k in EVAL_KEYS} if totals is None
                      else {k: totals[k] + parts[k] for k in EVAL_KEYS})
            preds_all.append({k: v.cpu().numpy() for k, v in preds.items()})
            targets_all.append({k: np.asarray(torch.as_tensor(
                batch[k]).cpu()) for k in ('boxes', 'class_ids',
                                           'valid_mask')})
        map50, map50_95 = calculate_map(preds_all, targets_all)
        out = _host_means(totals, EVAL_KEYS, n)
        out.update({'mAP50': map50, 'mAP50_95': map50_95})
        return out

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
                        self.save(os.path.join(self.output_dir,
                                               'best_model.pt'))
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
                                           f'checkpoint_epoch_{epoch}.pt'))
                for cb in callbacks or []:
                    cb(epoch, train_metrics, val_metrics)
                self._save_history(history)
            except Exception as e:   # crash checkpoint + env-gated resume
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
        return history

    def _save_history(self, history: Dict[str, List[float]]) -> None:
        """`history.json` after every epoch (atomic rename), so a crash
        keeps the curves as the crash checkpoint keeps the weights."""
        path = os.path.join(self.output_dir, 'history.json')
        tmp = path + '.tmp'
        with open(tmp, 'w') as f:
            json.dump(history, f, indent=2)
        os.replace(tmp, path)

    # ------------------------------------------------------------------
    def save(self, path: str) -> None:
        """The model's state dict, the EMA (when tracked, so inference
        loaders serve it), the optimizer state, step and best_map."""
        save_checkpoint(path, self.model.state_dict(), ema=self.state.ema,
                        optimizer_state=self.state.optimizer.state_dict(),
                        step=self.state.step,
                        metadata={'best_map': self.best_map})
        logger.info('Checkpoint saved to %s', path)

    def load(self, path: str) -> None:
        """Resume: weights, BatchNorm buffers, optimizer, step, EMA and
        best_map."""
        ckpt = load_checkpoint(path)
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
            self.state.optimizer.load_state_dict(ckpt['optimizer'])
        self.state.step = int(ckpt.get('step', 0))
        self.best_map = (ckpt.get('metadata') or {}).get('best_map', 0.0)
        logger.info('Checkpoint loaded from %s', path)
