"""The device mesh. Counterpart of `yoloclip_tpu/parallel/mesh.py`.

An (n_data, n_model) grid of torch devices laid out row-major, as JAX's
`reshape(n_data, n_model)`: cell (d, m) is device d * n_model + m. The
'data' axis splits batches; the 'model' axis splits the vocabulary's
classes (`class_block`, the JAX package's `class_sharding`) or, with
`parallel/spatial.py`, the image height. In one of two modes:

  * one process drives every cell. A data row's devices run one worker
    thread each (`collectives.ShardThreads`) and exchange through the
    in-process backend; a device may be listed more than once (two shards on one
    card, or several on the CPU): that exercises the split and the merge,
    not the scaling;
  * one process per cell, `torch.distributed` initialised
    (`parallel/multihost.py::initialize`) with world = n_data x n_model:
    rank r sits at (r // n_model, r % n_model). The grid holds every
    rank's device, gathered at creation. `data_group` (alias `group`) is
    the ranks with this rank's model index: DistributedDataParallel's
    gradient mean, synchronised BatchNorm and the losses' global
    normalisers run over it. `model_group` is the ranks with this rank's
    data index (None without a model axis). `host_group` is a gloo group
    of every rank for gathers of host objects, `host_data_group` and
    `host_model_group` its two axes.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from yoloclip_tpu_torch.parallel.collectives import (ClassShard, class_block,
                                                     gather)


class Mesh:
    axis_names = ('data', 'model')

    def __init__(self, devices, data_group=None, model_group=None,
                 host_group=None, host_data_group=None,
                 host_model_group=None, local_batches: bool = False):
        grid = np.empty((len(devices), len(devices[0])), dtype=object)
        for i, row in enumerate(devices):
            for j, d in enumerate(row):
                grid[i, j] = torch.device(d)
        self.devices = grid
        self.data_group = data_group
        self.model_group = model_group
        self.host_group = host_group
        self.host_data_group = host_data_group
        self.host_model_group = host_model_group
        # multi-process: True when each process loads its own shard of the
        # data (--multihost), False when every process sees the global
        # batch and takes its rows (one host, --devices N)
        self.local_batches = local_batches

    @property
    def group(self):
        """The data axis's process group (None in one process)."""
        return self.data_group

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def multiprocess(self) -> bool:
        return self.data_group is not None

    @property
    def rank(self) -> int:
        """This process's index on the data axis (0 in one process)."""
        return dist.get_rank(self.data_group) if self.multiprocess else 0

    @property
    def model_index(self) -> int:
        """This process's index on the model axis (0 in one process)."""
        return (dist.get_rank(self.model_group)
                if self.model_group is not None else 0)

    @property
    def process_index(self) -> int:
        """This process's rank in the world (0 in one process)."""
        return dist.get_rank() if self.multiprocess else 0

    @property
    def local_devices(self) -> List[torch.device]:
        """The data-axis devices this process drives, in axis order: its
        own cell's with one process a cell, else the grid's first
        column."""
        if self.multiprocess:
            return [self.devices[self.rank, self.model_index]]
        return list(self.devices[:, 0])

    @property
    def local_device(self) -> torch.device:
        return self.local_devices[0]

    def class_block(self, n_classes: int):
        """(offset, size) of this process's block of a class axis of
        n_classes (the whole axis without a model axis)."""
        return class_block(n_classes, self.shape['model'], self.model_index)

    def text_shard(self, text: torch.Tensor) -> Optional[ClassShard]:
        """The ClassShard of this process's block of classes, `text`
        (..., size, E) being the block (None without a model axis). The
        axis's size and the block's offset come from the blocks' sizes,
        gathered over the host model group."""
        if self.model_group is None:
            return None
        sizes = gather(torch.tensor([text.shape[-2]]),
                       self.host_model_group)[:, 0].tolist()
        m = self.model_index
        return ClassShard(sum(sizes[:m]), sizes[m], sum(sizes),
                          self.model_group)

    def __repr__(self) -> str:
        names = [[str(d) for d in row] for row in self.devices]
        mode = ', one process a cell' if self.multiprocess else ''
        return f'Mesh({self.shape}, devices={names}{mode})'


def replicas_by_device(model: torch.nn.Module, devices
                       ) -> Dict[torch.device, torch.nn.Module]:
    """One copy of `model` a distinct device of `devices` (the model itself
    on its own device). For inference: its forward in eval mode writes
    nothing, so the cells of one device share their copy."""
    import copy
    own = next(model.parameters()).device
    out: Dict[torch.device, torch.nn.Module] = {}
    for dev in devices:
        dev = torch.device(dev)
        if dev not in out:
            out[dev] = model if dev == own else copy.deepcopy(model).to(dev)
    return out


def default_devices() -> List[torch.device]:
    """Every local CUDA device, or the CPU where there is none (the JAX
    package's `jax.devices()`)."""
    if torch.cuda.is_available():
        return [torch.device(f'cuda:{i}')
                for i in range(torch.cuda.device_count())]
    return [torch.device('cpu')]


def _axis_groups(n_data: int, n_model: int, backend: Optional[str]):
    """(data group, model group) of this rank. Every rank creates every
    group, in the same order, as torch.distributed requires."""
    me = dist.get_rank()
    data = model = None
    for m in range(n_model):
        g = dist.new_group([d * n_model + m for d in range(n_data)],
                           backend=backend)
        if me % n_model == m:
            data = g
    for d in range(n_data):
        g = dist.new_group([d * n_model + m for m in range(n_model)],
                           backend=backend)
        if me // n_model == d:
            model = g
    return data, model


def create_mesh(n_data: Optional[int] = None, n_model: int = 1,
                devices: Optional[Sequence] = None,
                local_batches: bool = False) -> Mesh:
    """(n_data, n_model) mesh. In one process: over the first
    n_data * n_model of `devices` (default `default_devices()`; n_data
    defaults to len(devices) // n_model), row-major. With torch.distributed
    initialised: one cell a rank, n_data * n_model = the world size
    (n_data defaults to world // n_model), this rank's device `devices[0]`
    or the one `multihost.initialize` chose."""
    if n_model < 1:
        raise ValueError(f'n_model must be >= 1, got {n_model}')
    if dist.is_available() and dist.is_initialized():
        from yoloclip_tpu_torch.parallel import multihost
        world = dist.get_world_size()
        if n_data is None:
            n_data = world // n_model
        if n_data * n_model != world:
            raise ValueError(f'one process a cell: n_data x n_model '
                             f'({n_data} x {n_model}) must equal the world '
                             f'size ({world})')
        own = (torch.device(devices[0]) if devices
               else multihost.local_device())
        names: List[Optional[str]] = [None] * world
        dist.all_gather_object(names, str(own), group=multihost.host_group())
        grid = [names[d * n_model:(d + 1) * n_model] for d in range(n_data)]
        if n_model == 1:
            return Mesh(grid, data_group=dist.group.WORLD,
                        host_group=multihost.host_group(),
                        host_data_group=multihost.host_group(),
                        local_batches=local_batches)
        data, model = _axis_groups(n_data, n_model, None)
        host = ((data, model) if dist.get_backend() == 'gloo'
                else _axis_groups(n_data, n_model, 'gloo'))
        return Mesh(grid, data_group=data, model_group=model,
                    host_group=multihost.host_group(),
                    host_data_group=host[0], host_model_group=host[1],
                    local_batches=local_batches)
    devices = list(devices) if devices is not None else default_devices()
    if n_data is None:
        n_data = max(len(devices) // n_model, 1)
    if n_data < 1 or n_data * n_model > len(devices):
        raise ValueError(f'need {n_data}x{n_model} devices, have '
                         f'{len(devices)}')
    return Mesh([devices[d * n_model:(d + 1) * n_model]
                 for d in range(n_data)])


def batch_sharding(mesh: Mesh, batch_size: int,
                   accum: int = 1) -> List[torch.Tensor]:
    """The global rows each of this process's data-axis devices holds (a
    list of index tensors, in `mesh.local_devices` order), the leading
    (batch) axis split over 'data'. With accum > 1 micro-batch i of every
    device is its share of global rows [i*b, (i+1)*b), b = batch_size /
    accum, as the JAX package's accumulation over a sharded batch reads
    them."""
    n = mesh.shape['data']
    if batch_size % (n * accum):
        raise ValueError(f'batch size {batch_size} not divisible over '
                         f"{n} data-axis devices x {accum} micro-batches")
    rows = torch.arange(batch_size).reshape(accum, n, -1)
    if mesh.multiprocess:
        return [rows[:, mesh.rank].reshape(-1)]
    return [rows[:, i].reshape(-1) for i in range(n)]


def _take(v, idx: torch.Tensor, device):
    if isinstance(v, (list, tuple)):
        return [v[i] for i in idx.tolist()]
    if hasattr(v, 'shape') and len(v.shape) >= 1:
        t = torch.as_tensor(v)
        return t[idx.to(t.device)].to(device, non_blocking=True)
    return v


def shard_batch(batch: dict, mesh: Mesh, accum: int = 1) -> List[dict]:
    """A global batch dict -> one dict a local data-axis device, holding
    that device's rows (`batch_sharding`) on it. Arrays and lists (e.g.
    text_prompts) are split; scalars are passed through."""
    sizes = {len(v) for v in batch.values()
             if isinstance(v, (list, tuple))
             or (hasattr(v, 'shape') and len(v.shape) >= 1)}
    if len(sizes) != 1:
        raise ValueError(f'batch entries disagree on the batch size: '
                         f'{sorted(sizes)}')
    shards = batch_sharding(mesh, sizes.pop(), accum)
    return [{k: _take(v, idx, dev) for k, v in batch.items()}
            for idx, dev in zip(shards, mesh.local_devices)]
