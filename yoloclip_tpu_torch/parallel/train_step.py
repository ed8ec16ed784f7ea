"""Sharded training and inference steps over a ('data', 'model') mesh.
Counterpart of `yoloclip_tpu/parallel/train_step.py`.

The JAX package jits one step with the batch over 'data', the text's
classes over 'model' (`P('data', 'model', None)`) and the state
replicated; GSPMD inserts the collectives, and the step is exactly the
single-device step over the global batch. Here one process runs a mesh
cell (`parallel/multihost.py`), and the step is the single-device step
with what makes it the same step:

  * BatchNorm reduces its statistics over the global batch (the model's
    `BatchNorm2d` modules are given the data group);
  * the losses' batch-global normalisers are reduced over the data group;
  * with accumulation, micro-batch i across the ranks is global rows
    [i*b, (i+1)*b), as the JAX package slices a sharded batch
    (`mesh.batch_sharding`), and the gradients are averaged once, after
    the last micro-batch's backward;
  * no buffer broadcast in the forward: BatchNorm buffers are never
    overwritten from rank 0, so a desynchronised statistic shows instead
    of being hidden;
  * with a model axis each rank holds its data rows and its BLOCK of the
    classes (`place_text`): the neck's class max, the (score, id) merge,
    the contrastive softmax's log-sum-exp and the losses' sums over
    classes run over the model group (`parallel/collectives.py`), whose
    differentiable exchanges all have the "sum" adjoint. Every rank then
    holds its share of the gradient, and the shares of a data row's model
    ranks sum to n_model times that row's gradient; DDP's MEAN over the
    whole world (data x model) is then exactly the data rows' mean, the
    unsharded step's gradient over the global batch.

The train and eval steps run as programs, as JAX jits them
(`make_sharded_train_step`, `make_sharded_eval_step`): the bare model, the
gradients averaged by `collectives.all_reduce_gradients` (DDP's average,
without its reducer), on the card a CUDA graph a key holding NCCL's
collectives, on the CPU the same body over gloo without capture. The
eager route (eager=True) wraps the model in DistributedDataParallel
(`no_sync` on all but the last micro-batch); it is the route over gloo on
the card, where two ranks share one device and nothing can be captured.

`make_sharded_inference` runs the class-sharded forward (the 'yoloclip'
family only; YOLO-World v2 is refused): with one
process a cell as the 'sharded_inference' program (JAX jits it), on the
card a CUDA graph holding NCCL's class exchanges; in one process each data
row's model-axis devices run one persistent worker thread each, eagerly,
the exchanges through the in-process backend.
"""

from __future__ import annotations

import copy
import functools
import inspect
from typing import Dict, List, Optional

import torch
import torch.distributed as dist
from torch import nn
from torch.nn.parallel import DistributedDataParallel

from yoloclip_tpu_torch.config import TrainingConfig, family_of
from yoloclip_tpu_torch.inference.program import KeyAgreement, ProgramCache
from yoloclip_tpu_torch.models import layers
from yoloclip_tpu_torch.models.layers import BatchNorm2d
from yoloclip_tpu_torch.parallel import collectives as col
from yoloclip_tpu_torch.parallel.mesh import (Mesh, replicas_by_device,
                                              shard_batch)
from yoloclip_tpu_torch.train.train_state import (TrainState, make_eval_step,
                                                  make_train_step)


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


def sharded_programs(mesh: Mesh) -> ProgramCache:
    """A ProgramCache for the sharded steps of `mesh`: its ranks agree on
    every call's key over the mesh's host group."""
    return ProgramCache(agreement=KeyAgreement(mesh.host_group))


def sharded_step_blocker(mesh: Mesh) -> Optional[str]:
    """Why the sharded steps of `mesh` cannot run as programs on this
    rank's device (`collectives.capture_blocker`; None where they can)."""
    if not mesh.multiprocess:
        return None
    return col.capture_blocker(mesh.local_device, mesh.group,
                               mesh.model_group, dist.group.WORLD)


def _step_programs(mesh: Mesh, programs: Optional[ProgramCache],
                   eager: bool, what: str = 'the sharded steps'
                   ) -> Optional[ProgramCache]:
    """The cache a sharded step's programs go in: `programs`, else a new
    one (`sharded_programs` over a process group); None for the eager
    route. Raises where the programs cannot be captured."""
    if eager:
        return None
    reason = sharded_step_blocker(mesh)
    if reason is not None:
        raise RuntimeError(f'{what} cannot run as programs on '
                           f'{mesh.local_device}: {reason} (eager=True runs '
                           f'them eagerly)')
    if programs is not None:
        return programs
    return sharded_programs(mesh) if mesh.multiprocess else ProgramCache()


def make_sharded_train_step(cfg: TrainingConfig, mesh: Mesh,
                            programs: Optional[ProgramCache] = None,
                            eager: bool = False):
    """compile_for(state) -> train_step(state, batch, text) over `mesh`,
    the JAX function's shape. The batch is this rank's rows
    (`place_batch`), the text its rows and class block (`place_text`); the
    returned loss parts are the global batch's.

    The step runs as the 'train_step' program of `programs` (default: a
    new `sharded_programs(mesh)`), as JAX jits the sharded step: the bare
    model, the gradient average by `collectives.all_reduce_gradients`,
    the optimizer and the EMA, on the card one CUDA graph holding NCCL's
    collectives. Every rank must call it with the same settings and batch
    shapes (the cache's agreement raises on every rank where they differ).
    Over gloo on a CUDA device (ranks sharing a card) it raises: gloo's
    collectives cannot be captured. eager: the eager route instead, a
    DistributedDataParallel wrapper of the model built at its first call
    (the reading beside the program, and the route over gloo on the card;
    see `_lazy_ddp_step`). On a one-cell mesh without a process group the
    step is the 1-device step, a program of `programs` (or eager)."""
    def compile_for(state: TrainState):
        if not mesh.multiprocess:
            if mesh.shape != {'data': 1, 'model': 1}:
                raise ValueError(
                    'data-parallel training runs one process a data-axis '
                    'device, and class-parallel training one a mesh cell: '
                    'initialise torch.distributed '
                    '(parallel/multihost.py::initialize, or cli.train '
                    '--devices N) before create_mesh')
            return make_train_step(cfg, programs=_step_programs(
                mesh, programs, eager))
        # one data rank has nothing to synchronise: its BatchNorm stays the
        # plain module
        set_batchnorm_group(state.model, mesh.group
                            if mesh.shape['data'] > 1 else None)
        if eager:
            return _lazy_ddp_step(cfg, mesh, state.model)
        return make_train_step(cfg, group=mesh.group,
                               shard_text=mesh.text_shard,
                               programs=_step_programs(mesh, programs, False),
                               grad_group=dist.group.WORLD)

    return compile_for


def _lazy_ddp_step(cfg: TrainingConfig, mesh: Mesh, model: nn.Module):
    """The eager route's step, its DistributedDataParallel wrapper built
    at the first call (every rank's, together: the construction
    broadcasts the model). Not before: the wrapper keeps the parameters'
    gradient accumulators alive, bound to the stream it was built on, and
    a program's captured backward on the capture stream then has to wait
    on that stream, which a capture refuses. So a model whose eager route
    has run captures no new program."""
    built = []

    def train_step(state: TrainState, batch, text):
        if not built:
            dev = mesh.local_device
            ddp = DistributedDataParallel(
                model,
                device_ids=[dev.index or 0] if dev.type == 'cuda' else None,
                process_group=dist.group.WORLD, find_unused_parameters=False,
                **_NO_BUFFER_SYNC)
            built.append(make_train_step(cfg, ddp=ddp, group=mesh.group,
                                         shard_text=mesh.text_shard))
        return built[0](state, batch, text)

    train_step.agreed = make_train_step(cfg).agreed   # the program's key
    return train_step


def make_sharded_eval_step(cfg: TrainingConfig, mesh: Mesh,
                           programs: Optional[ProgramCache] = None,
                           eager: bool = False):
    """eval_step(state, batch, text) over `mesh` (this rank's rows and
    class block; the loss parts the global batch's, the predictions this
    rank's), the 'eval_step' program of `programs` on the terms of
    `make_sharded_train_step`; eager: the same body without a program."""
    cache = _step_programs(mesh, programs, eager)
    if not mesh.multiprocess:
        return make_eval_step(cfg, programs=cache)
    return make_eval_step(cfg, group=mesh.group, shard_text=mesh.text_shard,
                          programs=cache)


def make_sharded_inference(model: nn.Module, mesh: Mesh,
                           programs: Optional[ProgramCache] = None,
                           eager: bool = False):
    """run(images, text, **model_kwargs) -> the model's outputs for each
    data-axis device this process drives, in axis order, every launch made
    before any result is read. The GLOBAL batch of images splits over the
    data axis (this rank's rows when one process runs a cell); text (C, E)
    or (B, C, E) is the whole vocabulary (with B the global batch), its
    classes split over the model axis (a class_mask (C,) with them).
    scores and class_ids are global, `similarity` and `text_embeddings`
    the first block's.

    One process a cell: the rank's forward runs as the program
    'sharded_inference' of `programs` (default: a new
    `sharded_programs(mesh)`), as JAX jits the sharded forward; on the card
    one CUDA graph holding NCCL's class-max and (score, id) merge
    all-reduces over the model group. The class shard is computed before
    the program (its block sizes are gathered over the host group, which
    no graph may hold) and enters the key with the replica, its dtypes and
    int8 form and the keyword arguments that are not tensors; a class_mask
    is an input. Every rank must call with the same shapes and settings
    (`ProgramKeyMismatch` on every rank otherwise). Over gloo on a CUDA
    device (ranks sharing a card) it raises, as the sharded steps do;
    eager=True runs the same forward without a program.

    In one process a data row's model-axis devices run one thread each,
    the first of them returning the row's outputs. That route stays eager:
    its exchanges meet at a host barrier that no graph can hold.

    Only the 'yoloclip' family shards its classes; another raises."""
    arch = family_of(getattr(model, 'cfg', None))
    if arch != 'yoloclip':
        raise NotImplementedError(f'the class-sharded forward runs the '
                                  f'yoloclip family only, not '
                                  f'{arch!r}')
    cache = (_step_programs(mesh, programs, eager, 'the class-sharded '
                            'forward') if mesh.multiprocess else None)
    replicas = replicas_by_device(model, mesh.local_devices
                                  if mesh.multiprocess
                                  else mesh.devices.reshape(-1))
    n_model = mesh.shape['model']
    workers = (col.ShardThreads(mesh.devices.size)
               if n_model > 1 and not mesh.multiprocess else None)
    forms = {dev: _model_form(m) for dev, m in replicas.items()}

    @torch.inference_mode()
    def run(images: torch.Tensor, text: torch.Tensor,
            **model_kwargs) -> List[Dict]:
        batch = {'images': images}
        if text.dim() == 3:
            batch['text'] = text
        shards = shard_batch(batch, mesh)
        if mesh.multiprocess:
            (s,) = shards
            dev = s['images'].device
            t = s.get('text', text)   # this rank's rows, every class
            t = t.narrow(-2, *mesh.class_block(t.shape[-2])).to(dev)
            shard = mesh.text_shard(t) if n_model > 1 else None
            kw = dict(model_kwargs)
            mask = kw.pop('class_mask', None)
            inputs = [s['images'], t]
            if mask is not None:
                mask = torch.as_tensor(mask)
                inputs.append((mask if shard is None
                               else shard.take(mask, -1)).to(dev))
            body = functools.partial(_forward, replicas[dev], shard, kw)
            if cache is None:
                return [body(*inputs)]
            key = (replicas[dev], forms[dev], layers.STORE_INT8_MIN_ELEMS,
                   None if shard is None else shard.total,
                   tuple(sorted(kw.items())))
            # the ranks agree on the global inputs; their blocks' shapes
            # and offsets are their own
            agreed = ('sharded_inference', key) + tuple(
                (tuple(x.shape), x.dtype) for x in (images, text, mask)
                if x is not None)
            return [cache.run('sharded_inference', key, body, inputs, dev,
                              agreed=agreed, local=None if shard is None
                              else (shard.offset, shard.size))]
        if n_model == 1:
            return [replicas[dev](s['images'], s.get('text', text).to(dev),
                                  **model_kwargs)
                    for s, dev in zip(shards, mesh.local_devices)]
        C = text.shape[-2]
        fns, groups = [], []
        for d, s in enumerate(shards):
            group = col.LocalGroup(n_model)
            groups.append(group)
            for m in range(n_model):
                shard = col.ClassShard(*col.class_block(C, n_model, m), C,
                                       group.member(m))
                fns.append(_block_call(replicas[mesh.devices[d, m]],
                                       s['images'], shard.take(
                                           s.get('text', text)),
                                       mesh.devices[d, m], shard,
                                       model_kwargs))
        outs = workers.run(fns, groups)
        return outs[::n_model]

    return run


def _model_form(model: nn.Module) -> tuple:
    """What a program of `model` bakes in beyond its identity: its
    parameters' dtypes and whether it is the int8 deploy graph."""
    dtypes = sorted({str(p.dtype) for p in model.parameters()})
    int8 = any(getattr(m, 'mode', None) == 'int8' for m in model.modules())
    return tuple(dtypes), int8


def _forward(model, shard, kw, images, text, class_mask=None):
    """The class-sharded forward of one rank (a program's body)."""
    if shard is not None:
        kw = dict(kw, class_shard=shard)
    if class_mask is not None:
        kw = dict(kw, class_mask=class_mask)
    return model(images, text, **kw)


def _block_kwargs(kw: Dict, shard: col.ClassShard) -> Dict:
    """The model's keyword arguments for one class block: the shard, and
    its block of a (C,) class_mask."""
    kw = dict(kw, class_shard=shard)
    if kw.get('class_mask') is not None:
        kw['class_mask'] = shard.take(torch.as_tensor(kw['class_mask']), -1)
    return kw


def _block_call(model, images, text, dev, shard, kw):
    def call():
        with col.on_device(dev):
            return model(images.to(dev), text.to(dev),
                         **_block_kwargs(kw, shard))
    return call


def replicate_model(model: nn.Module, mesh: Mesh) -> List[nn.Module]:
    """One copy of `model` per local data-axis device; the first device
    equal to the model's own takes the model itself."""
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


def place_text(text, mesh: Mesh, batched: bool = True, accum: int = 1
               ) -> torch.Tensor:
    """The GLOBAL text -> this rank's block on its device: with batched
    its rows of a (B, C, E) text (laid out as `place_batch` lays out the
    batch), else the (C, E) matrix; of either, its block of the classes
    over 'model' (`mesh.class_block`)."""
    t = torch.as_tensor(text)
    if batched:
        t = shard_batch({'text': t}, mesh, accum)[0]['text']
    offset, size = mesh.class_block(t.shape[-2])
    return t.narrow(-2, offset, size).to(mesh.local_device)


def replicate_state(state: TrainState, mesh: Mesh) -> TrainState:
    """The state on this rank's device (every rank holds all of it)."""
    dev = mesh.local_device
    state.model.to(dev)
    if state.ema is not None:
        state.ema = {k: v.to(dev) for k, v in state.ema.items()}
    return state
