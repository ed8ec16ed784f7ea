"""Collectives over the data axis, for the parts of a data-parallel step
that must see the GLOBAL batch. Under `jax.jit` the JAX package's sharded
step computes exactly the unsharded step over the global batch, so its
BatchNorm statistics and its loss normalisers are global; a rank of a
`DistributedDataParallel` step sees only its shard. These helpers close
the gap:

  * `all_reduce_sum` / `all_gather_stack`: differentiable, their backward
    all-reduces the gradient (synchronised BatchNorm,
    `models/layers.py::BatchNorm2d`);
  * `group_sum` / `group_min` / `group_max`: detached, for the counts the
    losses divide by (`train/losses.py`) and the vocabulary bucket;
  * `world_scale`: DDP AVERAGES gradients over the ranks, so a rank's
    loss divided by a global count is multiplied by the world size.

Every helper takes group=None for a step without data parallelism and is
then the identity: nothing is computed, so such a step is bit for bit the
single-device one. Only SUM, MIN and MAX all-reduces are used, which gloo
also runs on CUDA tensors.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist


def world_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


class _AllReduceSum(torch.autograd.Function):
    """y = the sum of x over the group; dL/dx = the sum of dL/dy over the
    group (every rank's loss reads the same y)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, op=dist.ReduceOp.SUM, group=ctx.group)
        return grad, None


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
    rank = dist.get_rank(group)
    zero = torch.zeros_like(x)
    slots = torch.stack([x if r == rank else zero
                         for r in range(world_size(group))])
    return all_reduce_sum(slots, group)


def _reduced(x: torch.Tensor, op, group) -> torch.Tensor:
    y = x.detach().clone()
    dist.all_reduce(y, op=op, group=group)
    return y


def group_sum(x: torch.Tensor, group) -> torch.Tensor:
    """x summed over the group, detached (x with no group)."""
    return x if group is None else _reduced(x, dist.ReduceOp.SUM, group)


def group_min(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _reduced(x, dist.ReduceOp.MIN, group)


def group_max(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _reduced(x, dist.ReduceOp.MAX, group)


def group_mean(x: torch.Tensor, group) -> torch.Tensor:
    """x averaged over the group, detached (x with no group)."""
    if group is None:
        return x
    return _reduced(x, dist.ReduceOp.SUM, group) / world_size(group)


def world_scale(x: torch.Tensor, group: Optional[object]) -> torch.Tensor:
    """A rank's share of a globally normalised loss, scaled so that DDP's
    mean over the ranks is the global loss (x with no group)."""
    return x if group is None else x * world_size(group)
