"""Data-parallel training and inference steps over a mesh's 'data' axis.
Counterpart of `yoloclip_tpu/parallel/train_step.py`.

The JAX package jits one step with the batch sharded over 'data' and the
state replicated; GSPMD inserts the gradient all-reduce, and the step is
exactly the single-device step over the global batch. Here one process
runs a data-axis device (`parallel/multihost.py`), and the step is
DistributedDataParallel with what makes it the same step:

  * BatchNorm reduces its statistics over the global batch (the model's
    `BatchNorm2d` modules are given the group);
  * the losses' batch-global normalisers are reduced over the group;
  * with accumulation, micro-batch i across the ranks is global rows
    [i*b, (i+1)*b), as the JAX package slices a sharded batch
    (`mesh.batch_sharding`), and the gradient all-reduce runs on the last
    micro-batch only (`no_sync`);
  * no buffer broadcast in the forward: BatchNorm buffers are never
    overwritten from rank 0, so a desynchronised statistic shows instead
    of being hidden.

The 'model' axis (vocabulary sharding) is not ported (`parallel/mesh.py`).
"""

from __future__ import annotations

import inspect
from typing import Dict, List

import torch
from torch import nn
from torch.nn.parallel import DistributedDataParallel

from yoloclip_tpu_torch.config import TrainingConfig
from yoloclip_tpu_torch.models.layers import BatchNorm2d
from yoloclip_tpu_torch.parallel.mesh import Mesh, shard_batch
from yoloclip_tpu_torch.train.train_state import TrainState, make_train_step


# No buffer broadcast in the forward. Newer torch names the option
# forward_sync_buffers (it still syncs at construction, where every rank's
# buffers are equal anyway); older torch only knows broadcast_buffers.
_NO_BUFFER_SYNC = ({'forward_sync_buffers': False} if 'forward_sync_buffers'
                   in inspect.signature(DistributedDataParallel).parameters
                   else {'broadcast_buffers': False})


def set_batchnorm_group(model: nn.Module, group) -> int:
    """Give every BatchNorm2d of the model the data axis's group (None
    turns synchronisation off). Returns how many there were."""
    n = 0
    for m in model.modules():
        if isinstance(m, BatchNorm2d):
            m.group = group
            n += 1
    return n


def make_sharded_train_step(cfg: TrainingConfig, mesh: Mesh):
    """compile_for(state) -> train_step(state, batch, text) over `mesh`,
    the JAX function's shape. The batch is this rank's rows
    (`place_batch`); the returned loss parts are the global batch's. On a
    one-device mesh without a process group the step is the plain one."""
    def compile_for(state: TrainState):
        if not mesh.multiprocess:
            if mesh.shape['data'] != 1:
                raise ValueError(
                    'data-parallel training runs one process a data-axis '
                    'device: initialise torch.distributed '
                    '(parallel/multihost.py::initialize, or cli.train '
                    '--devices N) before create_mesh')
            return make_train_step(cfg)
        # one rank has nothing to synchronise: its BatchNorm stays the
        # plain module, so a 1-rank step is the step without DDP
        set_batchnorm_group(state.model, mesh.group
                            if mesh.shape['data'] > 1 else None)
        dev = mesh.local_device
        ddp = DistributedDataParallel(
            state.model,
            device_ids=[dev.index or 0] if dev.type == 'cuda' else None,
            process_group=mesh.group, find_unused_parameters=False,
            **_NO_BUFFER_SYNC)
        return make_train_step(cfg, ddp=ddp, group=mesh.group)

    return compile_for


def make_sharded_inference(model: nn.Module, mesh: Mesh):
    """run(images, text, **model_kwargs) -> the model's outputs for each
    data-axis device this process drives, in axis order: a replica of
    `model` on each (the model itself where the device is its own), the
    GLOBAL batch of images split over the data axis (this rank's rows
    when one process runs a device), every launch made before any result
    is read. text (C, E) is shared: the vocabulary is not sharded."""
    replicas = replicate_model(model, mesh)

    @torch.inference_mode()
    def run(images: torch.Tensor, text: torch.Tensor,
            **model_kwargs) -> List[Dict]:
        shards = shard_batch({'images': images}, mesh)
        return [m(s['images'], text.to(s['images'].device), **model_kwargs)
                for m, s in zip(replicas, shards)]

    return run


def replicate_model(model: nn.Module, mesh: Mesh) -> List[nn.Module]:
    """One copy of `model` per local data-axis device; the first device
    equal to the model's own takes the model itself."""
    import copy
    own = next(model.parameters()).device
    out, used = [], False
    for dev in mesh.local_devices:
        if dev == own and not used:
            out.append(model)
            used = True
        else:
            out.append(copy.deepcopy(model).to(dev))
    return out


def place_batch(batch: Dict, mesh: Mesh, accum: int = 1) -> Dict:
    """A GLOBAL batch dict -> this rank's rows on its device, micro-batch
    laid out (`mesh.batch_sharding`); list entries such as text_prompts are
    split the same way."""
    return shard_batch(batch, mesh, accum)[0]


def replicate_state(state: TrainState, mesh: Mesh) -> TrainState:
    """The state on this rank's device (every rank holds all of it)."""
    dev = mesh.local_device
    state.model.to(dev)
    if state.ema is not None:
        state.ema = {k: v.to(dev) for k, v in state.ema.items()}
    return state
