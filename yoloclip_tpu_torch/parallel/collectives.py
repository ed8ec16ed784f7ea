"""Collectives over one axis of the mesh, for the parts of a sharded step
that must see the whole axis. Under `jax.jit` the JAX package's sharded
step computes exactly the unsharded step, and GSPMD inserts whatever the
shardings need; here the exchanges are written out.

The data axis (a `DistributedDataParallel` rank sees only its rows):

  * `all_reduce_sum` / `all_gather_stack`: differentiable, their backward
    all-reduces the gradient (synchronised BatchNorm,
    `models/layers.py::BatchNorm2d`);
  * `group_sum` / `group_min` / `group_max`: detached, for the counts the
    losses divide by (`train/losses.py`) and the vocabulary bucket;
  * `world_scale`: DDP AVERAGES gradients over the ranks, so a rank's
    loss divided by a global count is multiplied by the world size;
  * `all_reduce_gradients`: that average without DDP's reducer, for a
    step captured as a CUDA graph (`capture_blocker` says when a group's
    collectives cannot be captured).

The model axis (the vocabulary's classes split in contiguous blocks,
`ClassShard`; the JAX package's `P('data', 'model', None)` text):

  * `class_max`: the max over the class axis, differentiable, its
    gradient split among exact ties over the WHOLE axis as `torch.amax`
    splits it (an autograd.Function: a local amax then a MAX all-reduce
    would split it per shard first);
  * `merge_argmax`: each shard's (score, local id) -> the global max and
    the lowest global id attaining it, as the unsharded argmax and the
    kernels break ties;
  * `logsumexp`: the vocabulary-parallel log-sum-exp (a global max, then
    a sum of exps);
  * `topk_values`: the global top-k values over the class axis.

Every helper takes `group`, one of:

  * None: no parallelism. Nothing is exchanged, so such a step is bit for
    bit the single-device one;
  * a torch.distributed process group (one process per grid cell). Only
    SUM, MIN and MAX all-reduces are used, which gloo also runs on CUDA
    tensors; a gather is an all-reduce of one-hot slots;
  * a `LocalRank`: the in-process backend. The shards of one process run
    one persistent worker thread each (`ShardThreads`) and exchange the
    list of per-device tensors through a barrier. Its backward runs where each thread runs
    its own graph, which is the CPU: the card's autograd engine runs one
    thread a device, so training on the card uses torch.distributed.

Sums over a group are added in rank order (the in-process backend) or by
the all-reduce, the same on every rank; with the "sum" adjoint of every
differentiable helper, the gradients of all ranks together are the
gradient of the sum of all ranks' losses.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import queue
import threading
import weakref
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist


# A shard waits this long for the others at an exchange (a shard that
# raises breaks the barrier at once: see ShardThreads.run).
BARRIER_TIMEOUT_S = 300.0


class LocalGroup:
    """The in-process backend of one mesh axis: `size` shards, each run by
    one thread of this process, exchanging tensors through a barrier. A
    shard's thread passes `member(rank)` as the `group`."""

    def __init__(self, size: int):
        self.size = size
        # two slot arrays, alternating: a shard writes exchange e + 2's
        # only after every shard has reached exchange e + 1's barrier,
        # that is, has read exchange e's -- one barrier an exchange
        self._slots: List[List[Optional[torch.Tensor]]] = [
            [None] * size, [None] * size]
        self._count = [0] * size
        self._barrier = threading.Barrier(size, timeout=BARRIER_TIMEOUT_S)

    def member(self, rank: int) -> 'LocalRank':
        return LocalRank(self, rank)

    def abort(self) -> None:
        """Wake every waiting shard with BrokenBarrierError (a shard
        failed: the others must not wait for it)."""
        self._barrier.abort()


@dataclasses.dataclass(frozen=True)
class LocalRank:
    group: LocalGroup
    rank: int

    def gather(self, x: torch.Tensor) -> List[torch.Tensor]:
        """Every shard's x, in rank order, on x's device (detached)."""
        g = self.group
        slots = g._slots[g._count[self.rank] % 2]
        g._count[self.rank] += 1
        slots[self.rank] = x.detach()
        g._barrier.wait()
        return [t.to(x.device) for t in slots]


def on_device(dev: torch.device):
    """The thread's current CUDA device set to dev (the kernels' ctypes
    launchers launch on the current device); nothing on the CPU."""
    if dev.type == 'cuda':
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def _serve(inbox: 'queue.SimpleQueue') -> None:
    """A shard worker: run each job put in its inbox until None comes."""
    while True:
        job = inbox.get()
        if job is None:
            return
        job()


def _stop(inboxes, threads) -> None:
    for q in inboxes:
        q.put(None)
    for t in threads:
        if t is not threading.current_thread():
            t.join()


class ShardThreads:
    """n persistent worker threads; worker r runs shard r of every call.
    A thread keeps its CUDA libraries' per-thread state warm across calls:
    cuDNN caches its execution plans per thread, so fresh threads rebuild
    them at every conv (milliseconds each). Calls are serialised: two at
    once could each hold a worker the other's barrier waits for. The
    workers stop on `close()`, when the object is collected, or at
    exit."""

    def __init__(self, n: int):
        self._inboxes = [queue.SimpleQueue() for _ in range(n)]
        threads = [threading.Thread(target=_serve, args=(q,), daemon=True,
                                    name=f'yoloclip-shard-{r}')
                   for r, q in enumerate(self._inboxes)]
        for t in threads:
            t.start()
        self._lock = threading.Lock()
        # stops and joins the workers: on close(), on collection, at exit
        self.close = weakref.finalize(self, _stop, self._inboxes, threads)

    def run(self, fns: Sequence[Callable[[], object]],
            groups: Sequence[Optional[LocalGroup]] = ()) -> list:
        """fns[r] on worker r; their results in order. A shard that raises
        aborts every group's barrier, so the others fail instead of
        waiting; the first real error is raised here. Grad mode and
        inference mode are thread-local: each worker takes the caller's."""
        n = len(fns)
        results: list = [None] * n
        errors: list = [None] * n
        done = [threading.Event() for _ in range(n)]
        grad = torch.is_grad_enabled()
        inference = torch.is_inference_mode_enabled()

        def job(r):
            try:
                with torch.inference_mode(inference), \
                        torch.set_grad_enabled(grad):
                    results[r] = fns[r]()
            except BaseException as e:   # re-raised by the caller below
                errors[r] = e
                for g in groups:
                    if g is not None:
                        g.abort()
            finally:
                done[r].set()

        with self._lock:
            for r in range(n):
                self._inboxes[r].put(functools.partial(job, r))
            for d in done:
                d.wait()
        real = [e for e in errors if e is not None
                and not isinstance(e, threading.BrokenBarrierError)]
        if real or any(e is not None for e in errors):
            raise (real or [e for e in errors if e is not None])[0]
        return results


def world_size(group) -> int:
    if group is None:
        return 1
    if isinstance(group, LocalRank):
        return group.group.size
    return dist.get_world_size(group)


def rank(group) -> int:
    if group is None:
        return 0
    if isinstance(group, LocalRank):
        return group.rank
    return dist.get_rank(group)


_REDUCE = {'sum': (dist.ReduceOp.SUM, lambda s: s.sum(0)),
           'min': (dist.ReduceOp.MIN, lambda s: s.amin(0)),
           'max': (dist.ReduceOp.MAX, lambda s: s.amax(0))}


def _reduce(x: torch.Tensor, op: str, group) -> torch.Tensor:
    """x reduced over the group, detached, the same on every rank."""
    if isinstance(group, LocalRank):
        return _REDUCE[op][1](torch.stack(group.gather(x)))
    y = x.detach().clone()
    dist.all_reduce(y, op=_REDUCE[op][0], group=group)
    return y


def gather(x: torch.Tensor, group) -> torch.Tensor:
    """(world, *x.shape), row r from rank r, detached (x[None] with no
    group). Across processes an all-reduce of one-hot slots: adding zeros
    is exact, so the rows are every rank's x bit for bit."""
    if group is None:
        return x.detach()[None]
    if isinstance(group, LocalRank):
        return torch.stack(group.gather(x))
    r = rank(group)
    slots = torch.stack([x.detach() if i == r else torch.zeros_like(x)
                         for i in range(world_size(group))])
    dist.all_reduce(slots, op=dist.ReduceOp.SUM, group=group)
    return slots


class _AllReduceSum(torch.autograd.Function):
    """y = the sum of x over the group; dL/dx = the sum of dL/dy over the
    group (every rank's loss reads the same y)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _reduce(x, 'sum', group)

    @staticmethod
    def backward(ctx, grad):
        return _reduce(grad.contiguous(), 'sum', ctx.group), None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable sum over the group (x itself with no group)."""
    if group is None:
        return x
    return _AllReduceSum.apply(x, group)


def all_gather_stack(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable gather: (world, *x.shape), row r from rank r, the
    same on every rank. Done as the sum of one-hot slots, so it needs only
    an all-reduce; adding zeros is exact, so the rows are x bit for bit."""
    if group is None:
        return x[None]
    r = rank(group)
    zero = torch.zeros_like(x)
    slots = torch.stack([x if i == r else zero
                         for i in range(world_size(group))])
    return all_reduce_sum(slots, group)


def group_sum(x: torch.Tensor, group) -> torch.Tensor:
    """x summed over the group, detached (x with no group)."""
    return x if group is None else _reduce(x, 'sum', group)


def group_min(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _reduce(x, 'min', group)


def group_max(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _reduce(x, 'max', group)


def group_mean(x: torch.Tensor, group) -> torch.Tensor:
    """x averaged over the group, detached (x with no group)."""
    if group is None:
        return x
    return _reduce(x, 'sum', group) / world_size(group)


def world_scale(x: torch.Tensor, group: Optional[object]) -> torch.Tensor:
    """A rank's share of a globally normalised loss, scaled so that DDP's
    mean over the ranks is the global loss (x with no group)."""
    return x if group is None else x * world_size(group)


# DistributedDataParallel's default bucket cap
BUCKET_BYTES = 25 * 2 ** 20


def all_reduce_gradients(params, group) -> None:
    """The gradients of `params` averaged over the process group `group`
    in place, as DistributedDataParallel's default hook averages them:
    each multiplied by 1 / world size, then summed by an all-reduce (on two
    ranks the sum does not depend on the order, so the result is DDP's bit
    for bit). Coalesced: one flat all-reduce a dtype and BUCKET_BYTES, in
    parameter order. A parameter with no gradient takes zeros, as its
    slot in DDP's bucket does. Device work only, no host sync and no
    reducer state, so a captured program can hold it; call it once, after
    the last micro-batch's backward."""
    if group is None:
        return
    scale = 1.0 / world_size(group)
    open_: dict = {}     # dtype -> (its open bucket, the bucket's bytes)
    buckets = []
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        grads, size = open_.get(p.grad.dtype, (None, 0))
        if grads is None or size + p.grad.nbytes > BUCKET_BYTES:
            grads, size = [], 0
            buckets.append(grads)
        grads.append(p.grad)
        open_[p.grad.dtype] = (grads, size + p.grad.nbytes)
    for grads in buckets:
        flat = torch.cat([g.reshape(-1) for g in grads]).mul_(scale)
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        torch._foreach_copy_(grads, [v.view_as(g) for v, g in zip(
            flat.split([g.numel() for g in grads]), grads)])


def capture_blocker(device, *groups) -> Optional[str]:
    """Why a CUDA graph on `device` cannot hold collectives over `groups`
    (None where it can, or off CUDA: there a program runs its body without
    capture). Only NCCL enqueues its collectives on the device; gloo runs
    them on the host (the case of two ranks sharing one card, which NCCL
    refuses), and the in-process backend meets at a host barrier."""
    if torch.device(device).type != 'cuda':
        return None
    for g in groups:
        if g is None:
            continue
        backend = ('in-process' if isinstance(g, LocalRank)
                   else dist.get_backend(g))
        if backend != 'nccl':
            return (f'{backend} collectives run on the host, so a CUDA '
                    f'graph cannot capture them; a program over a process '
                    f'group on the card needs NCCL (one card a rank)')
    return None


# ---------------------------------------------------------------------------
# the model axis: the vocabulary's classes in contiguous blocks
# ---------------------------------------------------------------------------

def class_block(n_classes: int, n_shards: int, index: int):
    """(offset, size) of shard `index`'s classes: GSPMD's even blocks,
    ceil(C / n) each, the last ones short (possibly empty)."""
    per = -(-n_classes // n_shards)
    lo = min(index * per, n_classes)
    return lo, min(lo + per, n_classes) - lo


@dataclasses.dataclass(frozen=True)
class ClassShard:
    """This shard's block of the class axis: global classes [offset,
    offset + size) of `total`, and the model axis's group."""
    offset: int
    size: int
    total: int
    group: object

    def take(self, x: torch.Tensor, dim: int = -2) -> torch.Tensor:
        """This shard's block of a tensor over the whole class axis."""
        return x.narrow(dim, self.offset, self.size)

    def one_hot(self, labels: torch.Tensor) -> torch.Tensor:
        """Global class ids (...,) -> this block's one-hot columns
        (..., size) in fp32."""
        cols = torch.arange(self.offset, self.offset + self.size,
                            device=labels.device)
        return (labels[..., None].long() == cols).float()


def _local_amax(x: torch.Tensor, dim: int) -> torch.Tensor:
    if x.shape[dim] == 0:   # an empty class block
        shape = list(x.shape)
        shape[dim] = 1
        return x.new_full(shape, float('-inf'))
    return x.amax(dim=dim, keepdim=True)


class _ClassMax(torch.autograd.Function):
    """The max over `dim` across the group (keepdim). Backward: the sum of
    every rank's output gradient, split evenly among the entries equal to
    the max over the whole axis, as torch.amax's backward splits it."""

    @staticmethod
    def forward(ctx, x, dim, group):
        g = _reduce(_local_amax(x, dim), 'max', group)
        mask = x == g
        count = _reduce(mask.sum(dim=dim, keepdim=True, dtype=x.dtype),
                        'sum', group)
        ctx.save_for_backward(mask, count)
        ctx.group = group
        return g

    @staticmethod
    def backward(ctx, grad):
        mask, count = ctx.saved_tensors
        grad = _reduce(grad.contiguous(), 'sum', ctx.group)
        return (grad / count) * mask, None, None


def class_max(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """max over `dim` (keepdim) of a tensor whose `dim` is split over the
    group; torch.amax with no group."""
    if group is None:
        return x.amax(dim=dim, keepdim=True)
    if not (torch.is_grad_enabled() and x.requires_grad):
        return _reduce(_local_amax(x, dim), 'max', group)
    return _ClassMax.apply(x, dim, group)


def merge_argmax(scores: torch.Tensor, ids: torch.Tensor, offset: int,
                 group):
    """Each shard's max score and LOCAL argmax (same shape) -> the global
    max and the lowest GLOBAL id attaining it, the same on every shard
    (ids keep their dtype). Detached: the scores train nothing."""
    if group is None:
        return scores, ids
    s = gather(scores, group)
    i = gather(ids.long() + offset, group)
    best, bid = s[0], i[0]
    for k in range(1, s.shape[0]):
        take = s[k] > best   # strictly: a tie keeps the lower shard
        best = torch.where(take, s[k], best)
        bid = torch.where(take, i[k], bid)
    return best, bid.to(ids.dtype)


def logsumexp(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """log(sum(exp(x))) over `dim` split over the group (dim removed),
    differentiable: a global max (held constant), then the all-reduced sum
    of exps."""
    if group is None:
        return torch.logsumexp(x, dim=dim)
    with torch.no_grad():
        m = _reduce(_local_amax(x, dim), 'max', group)
        m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    s = all_reduce_sum((x - m).exp().sum(dim=dim, keepdim=True), group)
    return (m + s.log()).squeeze(dim)


def topk_values(x: torch.Tensor, k: int, group) -> torch.Tensor:
    """The k largest values over the last axis split over the group,
    descending, differentiable: each shard's top min(k, size) (padded
    with -inf), gathered, then the top k of those."""
    if group is None:
        return torch.topk(x, k, dim=-1).values
    kl = min(k, x.shape[-1])
    local = torch.topk(x, kl, dim=-1).values
    if kl < k:
        local = torch.cat([local, local.new_full(local.shape[:-1]
                                                 + (k - kl,),
                                                 float('-inf'))], dim=-1)
    cand = all_gather_stack(local, group)            # (n, ..., k)
    cand = cand.movedim(0, -2).reshape(*x.shape[:-1], -1)
    return torch.topk(cand, k, dim=-1).values
