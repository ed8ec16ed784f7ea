"""Spatially partitioned inference: several devices share ONE frame.
Counterpart of `yoloclip_tpu/parallel/spatial.py` (same three names).

'data'-axis batch sharding scales throughput but cannot cut the latency
of one frame. This module splits the canvas HEIGHT over mesh axes, so the
conv-dominated backbone, neck and heads of one forward split across
devices. GSPMD inserts the halo exchanges for the JAX package; here they
are written out, inside the modules, and the model's own `forward` runs
once a shard (SPMD-style): one thread a shard device in one process, the
exchanges through `parallel/collectives.py`'s in-process backend on
workers that persist with the detector; or one process a mesh cell
(`CellForward`), the exchanges over torch.distributed groups:

  * rows: the canvas height splits in blocks of the total stride (32
    rows), so every level's shard edge falls on a whole row; shards may be
    uneven (160 px over 4: 2/1/1/1 blocks); more shards than blocks is
    refused;
  * halos (`halo`): each Conv2d and max pool with a kernel over one row
    takes its neighbours' edge rows, runs UNCHANGED on the extended rows
    (its own padding: zeros or -inf at the frame's edges) and crops the
    halo's outputs. A stride-1 3x3 conv takes 1 row each side, a stride-2
    3x3 conv 2 rows above (1 is read; 2 keep its outputs on the global
    stride-2 grid, the shard's first row being even), each of SPPF's
    chained 5x5 pools 2 rows each side. cuDNN, the space-to-depth stems
    and the int8 conv kernel run as they are. Nearest x2 upsample, concat,
    eval-mode BatchNorm, 1x1 convs and the max-sigmoid gate need none.
    An int8-stored edge (`models/layers.py::QT`) crosses a halo as its
    int8 rows, its scale shared; whether a block stores one is decided on
    the whole frame's rows (`global_rows`), as GSPMD's global shapes
    decide it for the JAX package;
  * global ops: I-Pool's 3x3 adaptive max pool (`adaptive_max_pool3`)
    takes each window's max over the shard's rows (-inf where it has
    none), then a MAX all-reduce, so the text after I-Pool is the same on
    every shard;
  * the anchor tail (similarity, DFL decode, NMS) runs replicated on the
    heads' maps gathered level by level in global row order
    (`gather_rows`), as the JAX module's notes say GSPMD runs it.

Only the 'yoloclip' family splits: `spatialize_detector` refuses
another (YOLO-World v2's neck and head have no halo exchanges).

Modes (`spatialize_detector`, the JAX rules):
  * `detect()` (the host-letterbox canvas program): both axes fold into
    the height split, so a 2x2 mesh splits one frame 4 ways;
  * `detect_batch()`: batch over `batch_axis` x height over the remaining
    height axes (a batch axis is dropped from the height split);
  * the device-letterbox path stays single-device.

Across processes (one NCCL rank a card, as a multi-controller JAX program
runs) both re-routed paths stay the detector's programs: every rank is
called with the whole input, runs its cell inside the program, and
returns the whole input's detections; on the card a program is one CUDA
graph holding NCCL's exchanges. In one process the threads meet at host
barriers that no graph can hold, so the re-routed paths run eagerly.

The partition a thread runs under is a context variable (`partition`):
every conv of the model reads it, which an argument threaded through
every module's forward would do with far more code. Each new thread
starts outside any partition.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from yoloclip_tpu_torch.config import family_of
from yoloclip_tpu_torch.parallel import collectives as col

AxisName = Union[str, Sequence[str]]
BLOCK = 32   # the total stride: every level's shard edge is a whole row


def row_blocks(height: int, n: int) -> Tuple[int, ...]:
    """The number of 32-row blocks each of n shards holds of a canvas of
    `height` rows: as even as can be, the first shards one more."""
    if height % BLOCK:
        raise ValueError(f'canvas height {height} is not a multiple of '
                         f'{BLOCK}')
    nb = height // BLOCK
    if not 1 <= n <= nb:
        raise ValueError(f'cannot split {nb} blocks of {BLOCK} rows '
                         f'({height} px) over {n} shards')
    base, extra = divmod(nb, n)
    return tuple(base + (i < extra) for i in range(n))


@dataclasses.dataclass(frozen=True)
class HeightShard:
    """Shard `index` of a height split: `blocks` per shard, the height
    axis's `group` (a collectives group)."""
    blocks: Tuple[int, ...]
    index: int
    group: object

    def ranges(self, rows: int) -> List[Tuple[int, int]]:
        """Every shard's global [start, stop) rows at a level where this
        shard holds `rows` rows."""
        per = rows // self.blocks[self.index]
        edges = np.concatenate([[0], np.cumsum(self.blocks)]) * per
        return [(int(a), int(b)) for a, b in zip(edges[:-1], edges[1:])]

    def split(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This shard's rows of a whole-frame tensor along `dim`."""
        per = x.shape[dim] // sum(self.blocks)
        return x.narrow(dim, per * sum(self.blocks[:self.index]),
                        per * self.blocks[self.index])


_PARTITION: contextvars.ContextVar[Optional[HeightShard]] = \
    contextvars.ContextVar('yoloclip_height_partition', default=None)


@contextlib.contextmanager
def partition(shard: Optional[HeightShard]):
    """Run the model under `shard` (None: unpartitioned) on this thread."""
    token = _PARTITION.set(shard)
    try:
        yield
    finally:
        _PARTITION.reset(token)


def current() -> Optional[HeightShard]:
    return _PARTITION.get()


def global_rows(rows: int) -> int:
    """The whole frame's rows at the level where this thread's shard
    holds `rows` (`rows` itself outside a partition)."""
    sh = current()
    return rows if sh is None else sh.ranges(rows)[-1][1]


def _edge_rows(x: torch.Tensor, k: int) -> torch.Tensor:
    """(B, C, 2k, W): the first k rows, then the last k (zero-padded where
    the shard holds fewer than k)."""
    h = x.shape[2]
    t = min(h, k)
    pad = x.new_zeros(x.shape[:2] + (k - t, x.shape[3]))
    return torch.cat([x[:, :, :t], pad, pad, x[:, :, h - t:]], dim=2)


def halo(op: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor,
         k: int, stride: int, pad_top: int) -> torch.Tensor:
    """op(x) for a row-window op (kernel k rows, stride, pad_top rows of
    its own padding above) on this thread's rows of an (N, C, H, W) map:
    the extended rows through the unchanged op, cropped to this shard's
    outputs. op(x) itself outside a partition."""
    sh = current()
    if sh is None or (k == 1 and stride == 1):
        return op(x)
    h = x.shape[2]
    ranges = sh.ranges(h)
    r0, r1 = ranges[sh.index]
    above = -(-pad_top // stride) * stride   # keeps the stride grid
    below = max(k - stride - pad_top, 0)
    K = max(above, below)
    edges = col.gather(_edge_rows(x, K), sh.group)   # (n, N, C, 2K, W)
    a, c = min(above, r0), min(below, ranges[-1][1] - r1)
    parts = []
    j, need = sh.index - 1, a
    while need > 0:   # from the shards above, nearest first
        t = min(need, K, ranges[j][1] - ranges[j][0])
        parts.insert(0, edges[j][:, :, 2 * K - t:])
        need, j = need - t, j - 1
    parts.append(x)
    j, need = sh.index + 1, c
    while need > 0:
        t = min(need, K, ranges[j][1] - ranges[j][0])
        parts.append(edges[j][:, :, :t])
        need, j = need - t, j + 1
    ext = torch.cat(parts, dim=2) if len(parts) > 1 else x
    if ext is not x and x.is_contiguous(memory_format=torch.channels_last):
        ext = ext.contiguous(memory_format=torch.channels_last)
    y = op(ext)
    return y[:, :, a // stride:a // stride + h // stride]


class _DeterministicAdaptiveMaxPool(torch.autograd.Function):
    """F.adaptive_max_pool2d with a backward that adds the gradients of
    overlapping windows in a fixed order (`index_put_` with accumulate,
    deterministic under torch.use_deterministic_algorithms). CUDA's own
    backward adds them atomically in no fixed order and has no
    deterministic mode, so without this a training run on the card could
    not be repeated bit for bit."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, size: Tuple[int, int]
                ) -> torch.Tensor:
        y, idx = F.adaptive_max_pool2d(x, size, return_indices=True)
        ctx.save_for_backward(idx)
        ctx.shape = x.shape
        return y

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        idx, = ctx.saved_tensors
        n, c, h, w = ctx.shape
        plane = torch.arange(n * c, device=idx.device).view(n, c, 1, 1)
        flat = (idx + plane * (h * w)).reshape(-1)
        gx = g.new_zeros(n * c * h * w).index_put_(
            (flat,), g.reshape(-1), accumulate=True)
        return gx.view(n, c, h, w), None


def _adaptive_max_pool(x: torch.Tensor, size: Tuple[int, int]
                       ) -> torch.Tensor:
    if (torch.are_deterministic_algorithms_enabled()
            and torch.is_grad_enabled() and x.requires_grad):
        return _DeterministicAdaptiveMaxPool.apply(x, size)
    return F.adaptive_max_pool2d(x, size)


def adaptive_max_pool3(x: torch.Tensor) -> torch.Tensor:
    """F.adaptive_max_pool2d(x, (3, 3)) of the whole frame's map, from
    this thread's rows: each window row's max over the rows the shard
    holds (-inf where it holds none), then a MAX all-reduce. Under
    torch.use_deterministic_algorithms its backward is deterministic."""
    sh = current()
    if sh is None:
        return _adaptive_max_pool(x, (3, 3))
    h = x.shape[2]
    r0, r1 = sh.ranges(h)[sh.index]
    H = sh.ranges(h)[-1][1]
    rows = []
    for i in range(3):
        lo, hi = max(i * H // 3, r0), min(-(-(i + 1) * H // 3), r1)
        if lo < hi:
            rows.append(_adaptive_max_pool(x[:, :, lo - r0:hi - r0],
                                           (1, 3)))
        else:
            rows.append(x.new_full(x.shape[:2] + (1, 3), float('-inf')))
    return col.group_max(torch.cat(rows, dim=2), sh.group)


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The whole frame's (N, C, H, W) map from every shard's rows, in
    global row order, on every shard (x outside a partition)."""
    sh = current()
    if sh is None:
        return x
    ranges = sh.ranges(x.shape[2])
    top = max(b - a for a, b in ranges)
    pad = x.new_zeros(x.shape[:2] + (top - x.shape[2], x.shape[3]))
    allr = col.gather(torch.cat([x, pad], dim=2), sh.group)
    return torch.cat([allr[j][:, :, :b - a]
                      for j, (a, b) in enumerate(ranges)], dim=2)


# ---------------------------------------------------------------------------
# the mesh-level API
# ---------------------------------------------------------------------------

def _axes(a: Optional[AxisName]) -> Tuple[str, ...]:
    if a is None:
        return ()
    return (a,) if isinstance(a, str) else tuple(a)


@dataclasses.dataclass(frozen=True)
class CanvasSharding:
    """An NHWC canvas's layout over a mesh: batch over `batch_axis` (None:
    unsplit), height over the `height_axes` folded in order. `spec` reads
    as the JAX PartitionSpec's entries."""
    mesh: object
    batch_axis: Optional[str]
    height_axes: Tuple[str, ...]

    @property
    def spec(self) -> tuple:
        h = (None if not self.height_axes else self.height_axes[0]
             if len(self.height_axes) == 1 else self.height_axes)
        return (self.batch_axis, h, None, None)

    def _fold(self, axes: Tuple[str, ...], cell: Dict[str, int]) -> int:
        i = 0
        for a in axes:
            i = i * self.mesh.shape[a] + cell[a]
        return i

    def layout(self) -> Tuple[int, int, Dict[Tuple[int, int],
                                             torch.device]]:
        """(batch shards, height shards, the device of each (batch,
        height) pair: its first cell in the grid's order)."""
        nb = self.mesh.shape[self.batch_axis] if self.batch_axis else 1
        nh = int(np.prod([self.mesh.shape[a] for a in self.height_axes]))
        cells: Dict[Tuple[int, int], torch.device] = {}
        n_data, n_model = self.mesh.devices.shape
        for d in range(n_data):
            for m in range(n_model):
                cell = {'data': d, 'model': m}
                key = (cell[self.batch_axis] if self.batch_axis else 0,
                       self._fold(self.height_axes, cell))
                cells.setdefault(key, self.mesh.devices[d, m])
        return nb, nh, cells

    def forward(self, replicas: Dict[torch.device, torch.nn.Module],
                batch_index: Optional[int] = None) -> Callable:
        """A callable with the model's signature, run over this layout:
        the (B, H, W, C) input split over batch shards (only batch shard
        `batch_index`'s devices, with the whole input as its rows, when
        given) and each shard's rows over its height group, the model's
        own forward in each. Returns the outputs of the whole input on the
        first batch shard's device (the height shards' outputs are equal:
        shard 0's). In one process: one thread a (batch, height) pair,
        eager. One process a cell: a `CellForward`, this rank's cell."""
        if self.mesh.multiprocess:
            return CellForward(self, replicas[self.mesh.local_device])
        nb, nh, cells = self.layout()
        shards = [batch_index] if batch_index is not None else range(nb)
        workers = col.ShardThreads(len(shards) * nh)

        def run(x: torch.Tensor, text: torch.Tensor, **kw):
            if x.shape[0] % len(shards):
                raise ValueError(f'batch {x.shape[0]} does not split over '
                                 f'{len(shards)} batch shards')
            blocks = row_blocks(_canvas_height(x), nh)
            rows = x.shape[0] // len(shards)
            fns, groups = [], []
            for bi, b in enumerate(shards):
                group = col.LocalGroup(nh) if nh > 1 else None
                groups.append(group)
                for hi in range(nh):
                    dev = cells[(b, hi)]
                    fns.append(_shard_call(
                        replicas[dev], x[bi * rows:(bi + 1) * rows], text,
                        HeightShard(blocks, hi, group.member(hi))
                        if group else None, dev, kw))
            outs = (workers.run(fns, groups) if len(fns) > 1
                    else [fns[0]()])
            firsts = [outs[i * nh] for i in range(len(shards))]
            if len(firsts) == 1:
                return firsts[0]
            dev = firsts[0]['boxes'].device
            return {k: ([torch.cat([f[k][i].to(dev) for f in firsts])
                         for i in range(len(v))] if isinstance(v, list)
                        else torch.cat([f[k].to(dev) for f in firsts]))
                    for k, v in firsts[0].items()}

        return run


def _canvas_height(x: torch.Tensor) -> int:
    """The canvas rows of a model input: (B, H/2, W/2, 12) is the uint8
    space-to-depth canvas."""
    return x.shape[1] * (2 if x.shape[-1] == 12 else 1)


def _axis_group(mesh, axis: str):
    return mesh.model_group if axis == 'model' else mesh.data_group


class CellForward:
    """The model's forward over this rank's cell of a `CanvasSharding`
    across processes (one NCCL rank a card, as a multi-controller JAX
    program runs): every rank is called with the WHOLE input, takes its
    batch shard's rows and, of those, its height shard's, runs the model
    under `partition` (the halo rows, the I-Pool max and the heads' maps
    exchanged by `collectives.gather` / `group_max`, exact all-reduces
    NCCL can capture), and returns the whole input's outputs: the anchor
    tail runs replicated after `gather_rows`, and the batch shards'
    outputs are gathered over the batch axis's group.

    The height group is the model group for 'model', the data group for
    'data', and the world for ('data', 'model') (rank r sits at (r //
    n_model, r % n_model), so the world's order is JAX's fold order);
    axes of size 1 fold away. `key` is what every rank shares (the
    layout), `place` this rank's (batch, height) shard."""

    def __init__(self, layout: CanvasSharding, model: torch.nn.Module):
        mesh = layout.mesh
        axes = tuple(a for a in layout.height_axes if mesh.shape[a] > 1)
        if len(axes) == 2 and axes != ('data', 'model'):
            raise ValueError(f'height over {axes} across processes: the '
                             f"process groups fold ('data', 'model') only")
        self.model = model
        self.nb = mesh.shape[layout.batch_axis] if layout.batch_axis else 1
        self.nh = int(np.prod([mesh.shape[a] for a in axes]))
        self.height_group = (None if not axes else dist.group.WORLD
                             if len(axes) == 2 else _axis_group(mesh,
                                                                axes[0]))
        self.batch_group = (_axis_group(mesh, layout.batch_axis)
                            if self.nb > 1 else None)
        cell = {'data': mesh.rank, 'model': mesh.model_index}
        self.place = (cell[layout.batch_axis] if layout.batch_axis else 0,
                      layout._fold(axes, cell))
        self.key = (layout.spec, self.nb, self.nh)

    def __call__(self, x: torch.Tensor, text: torch.Tensor, **kw):
        if x.shape[0] % self.nb:
            raise ValueError(f'batch {x.shape[0]} does not split over '
                             f'{self.nb} batch shards')
        rows = x.shape[0] // self.nb
        b, h = self.place
        xs = x[b * rows:(b + 1) * rows]
        shard = (HeightShard(row_blocks(_canvas_height(x), self.nh), h,
                             self.height_group) if self.nh > 1 else None)
        with partition(shard):
            out = self.model(xs if shard is None else shard.split(xs, 1),
                             text, **kw)
        if self.batch_group is None:
            return out
        return _gather_batch(out, self.batch_group)


def _gather_batch(out, group):
    """Each batch shard's outputs -> the whole batch's, on every rank
    (`collectives.gather`: exact)."""
    if isinstance(out, dict):
        return {k: _gather_batch(v, group) for k, v in out.items()}
    if isinstance(out, list):
        return [_gather_batch(v, group) for v in out]
    if out.dtype == torch.bool:
        return _gather_batch(out.to(torch.uint8), group).bool()
    return col.gather(out, group).flatten(0, 1)


def _shard_call(model, x, text, shard: Optional[HeightShard],
                dev: torch.device, kw):
    def call():
        with col.on_device(dev), partition(shard):
            xs = x.to(dev)
            if shard is not None:
                xs = shard.split(xs, 1)
            return model(xs, text.to(dev), **kw)
    return call


def canvas_sharding(mesh, batch_axis: Optional[AxisName] = None,
                    height_axis: AxisName = ('data', 'model')
                    ) -> CanvasSharding:
    """The layout of an NHWC canvas: batch over `batch_axis` (None =
    unsplit), height over `height_axis` (a mesh axis name or a tuple of
    names folded together)."""
    b = _axes(batch_axis)
    if len(b) > 1:
        raise ValueError('the batch splits over one mesh axis')
    return CanvasSharding(mesh, b[0] if b else None, _axes(height_axis))


def replicate_variables(model: torch.nn.Module, mesh
                        ) -> Dict[torch.device, torch.nn.Module]:
    """One replica of `model` on each distinct device of the mesh this
    process drives (the model itself on its own device): spatial
    partitioning splits activations, never weights
    (`mesh.replicas_by_device`)."""
    from yoloclip_tpu_torch.parallel.mesh import replicas_by_device
    return replicas_by_device(model, [mesh.local_device] if mesh.multiprocess
                              else mesh.devices.reshape(-1))


def spatialize_detector(detector, mesh,
                        height_axis: AxisName = ('data', 'model'),
                        batch_axis: Optional[AxisName] = None,
                        eager: bool = False):
    """Re-route `detector`'s canvas program (`detect()` through the
    host-letterbox canvas, and the server's batches when given no model)
    through a height split over `height_axis`, and `detect_batch()`
    through batch over `batch_axis` (if given) x height over the rest of
    `height_axis`. Returns the detector (changed in place). The
    device-letterbox path stays single-device.

    One process a cell (torch.distributed): each rank runs its cell
    (`CellForward`) and the two re-routed paths stay programs of
    `detector.programs`, the whole frame their input and this rank's shard
    in their key, their ranks agreeing on each call's key over the mesh's
    host group (`KeyAgreement`): every rank calls with the same frames, as
    a multi-controller JAX program is called. On the card a program is a
    CUDA graph holding NCCL's exchanges; over gloo on a CUDA device (ranks
    sharing a card) it raises, as the sharded steps do. eager=True runs
    the re-routed paths eagerly instead (also the bodies
    `_detect_batch_eager` and `_detect_canvases`, callable on their own).
    In one process the split runs threads and in-process exchanges, so the
    two re-routed paths run eagerly and their programs are dropped.
    Only the 'yoloclip' family splits; another raises."""
    arch = family_of(detector.config.model)
    if arch != 'yoloclip':
        raise NotImplementedError(f'the height split runs the yoloclip '
                                  f'family only, not {arch!r}')
    names = _axes(height_axis)
    if batch_axis is not None:
        # a mesh axis cannot split two dims at once: drop the batch axis
        # from the batched program's height split
        names = tuple(a for a in names if a not in _axes(batch_axis))
    single = canvas_sharding(mesh, None, height_axis)
    batched = canvas_sharding(mesh, batch_axis, names)
    programs = mesh.multiprocess and not eager
    if programs:
        from yoloclip_tpu_torch.inference.program import KeyAgreement
        reason = col.capture_blocker(mesh.local_device, mesh.data_group,
                                     mesh.model_group, dist.group.WORLD)
        if reason is not None:
            raise RuntimeError(f'the split detector cannot run as programs '
                               f'on {mesh.local_device}: {reason} '
                               f'(eager=True runs it eagerly)')
    if mesh.multiprocess and torch.device(detector.device) != \
            mesh.local_device:
        raise ValueError(f'the detector is on {detector.device}, this '
                         f"rank's cell on {mesh.local_device}")
    replicas = replicate_variables(detector.model, mesh)
    detector._canvas_model = single.forward(replicas)
    detector._batch_model = batched.forward(replicas)
    detector.spatial_mesh = mesh
    detector._split_programs = programs
    if programs:
        detector.programs.agreement = KeyAgreement(mesh.host_group)
    else:
        detector.programs.clear()    # the split paths run their eager bodies
    return detector
