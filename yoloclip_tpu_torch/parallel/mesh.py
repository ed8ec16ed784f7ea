"""The device mesh. Counterpart of `yoloclip_tpu/parallel/mesh.py`.

A ('data', 'model') grid of torch devices, in one of two modes:

  * one process drives every device of the grid: replicas of a model, one
    a data-axis device (the server and the streaming detector split their
    batches over them). A device may be listed twice (two replicas on one
    card, or two on the CPU): that exercises the split and the merge, not
    the scaling;
  * one process per data-axis device, `torch.distributed` initialised
    (`parallel/multihost.py::initialize`): the grid holds every rank's
    device, gathered at creation; this process owns `devices[rank, 0]`.
    `group` is the data axis's process group (DistributedDataParallel,
    synchronised BatchNorm, the losses' global normalisers) and
    `host_group` a gloo group for gathers of host objects.

Only the 'data' axis is ported. A 'model' axis above 1 (the JAX package
shards the vocabulary, and with `parallel/spatial.py` the image height,
over it) raises NotImplementedError naming its ROADMAP item; it is not
imitated by replicas.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

MODEL_AXIS_ITEM = ("ROADMAP.md, queue A, multi-device: the 'model' axis: "
                   'vocabulary sharding and spatial partitioning')


class Mesh:
    axis_names = ('data', 'model')

    def __init__(self, devices, group=None, host_group=None,
                 local_batches: bool = False):
        grid = np.empty((len(devices), len(devices[0])), dtype=object)
        for i, row in enumerate(devices):
            for j, d in enumerate(row):
                grid[i, j] = torch.device(d)
        self.devices = grid
        self.group = group
        self.host_group = host_group
        # multi-process: True when each process loads its own shard of the
        # data (--multihost), False when every process sees the global
        # batch and takes its rows (one host, --devices N)
        self.local_batches = local_batches

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def multiprocess(self) -> bool:
        return self.group is not None

    @property
    def rank(self) -> int:
        """This process's index on the data axis (0 in one process)."""
        return dist.get_rank(self.group) if self.multiprocess else 0

    @property
    def local_devices(self) -> List[torch.device]:
        """The data-axis devices this process drives, in axis order."""
        if self.multiprocess:
            return [self.devices[self.rank, 0]]
        return list(self.devices[:, 0])

    @property
    def local_device(self) -> torch.device:
        return self.local_devices[0]

    def __repr__(self) -> str:
        names = [str(d) for d in self.devices[:, 0]]
        mode = ', one process a device' if self.multiprocess else ''
        return f'Mesh({self.shape}, devices={names}{mode})'


def default_devices() -> List[torch.device]:
    """Every local CUDA device, or the CPU where there is none (the JAX
    package's `jax.devices()`)."""
    if torch.cuda.is_available():
        return [torch.device(f'cuda:{i}')
                for i in range(torch.cuda.device_count())]
    return [torch.device('cpu')]


def create_mesh(n_data: Optional[int] = None, n_model: int = 1,
                devices: Optional[Sequence] = None,
                local_batches: bool = False) -> Mesh:
    """('data', 'model') mesh. In one process: over `devices` (default
    `default_devices()`), the first n_data of them. With torch.distributed
    initialised: one data-axis device per rank, n_data = the world size,
    this rank's device `devices[0]` or the one `multihost.initialize`
    chose."""
    if n_model != 1:
        raise NotImplementedError(
            f'a mesh with a model axis of {n_model} is not ported '
            f'({MODEL_AXIS_ITEM})')
    if dist.is_available() and dist.is_initialized():
        from yoloclip_tpu_torch.parallel import multihost
        world = dist.get_world_size()
        if n_data not in (None, world):
            raise ValueError(f'one process per data-axis device: n_data '
                             f'({n_data}) must equal the world size '
                             f'({world})')
        own = (torch.device(devices[0]) if devices
               else multihost.local_device())
        names: List[Optional[str]] = [None] * world
        dist.all_gather_object(names, str(own), group=multihost.host_group())
        return Mesh([[n] for n in names], group=dist.group.WORLD,
                    host_group=multihost.host_group(),
                    local_batches=local_batches)
    devices = list(devices) if devices is not None else default_devices()
    if n_data is None:
        n_data = len(devices)
    if not 1 <= n_data <= len(devices):
        raise ValueError(f'need {n_data}x{n_model} devices, have '
                         f'{len(devices)}')
    return Mesh([[d] for d in devices[:n_data]])


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
