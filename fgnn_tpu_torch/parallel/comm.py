"""The port's collectives, each with the backward that its use needs.

Under jit over a mesh the JAX package gets these from XLA; here each is
written out as a ``torch.autograd.Function`` over a process group:

* ``all_reduce_sum``: the sum over the group's ranks; backward: the sum of
  the cotangents (each rank's loss depends on every rank's input).  The
  global BatchNorm statistics take it.
* ``sum_over_ranks`` / ``replicated``: the two halves of a replicated-in,
  replicated-out op (``edge_partition.py``): the sum of the ranks'
  partials, whose cotangent is the one replicated cotangent (backward: the
  identity); and the identity on a replicated input, whose gradient is the
  sum of the ranks' partial gradients (backward: the sum).  Together they
  give every rank the gradients of one replicated loss, as JAX's
  ``shard_map`` transposes its ``psum``.
* ``gather_shards``: the full tensor from the ranks' shards of a tensor-
  parallel parameter.  The compute after it is replicated over the group,
  so the gradient of a shard is this rank's slice of the (replicated)
  gradient, not a sum over the group: ``torch.distributed.nn``'s
  ``all_gather`` sums, which would multiply it by the group's size.
* ``all_to_all_start``: ``all_to_all_single`` of equal splits, issued
  asynchronously; backward: the same exchange of the cotangents (the
  halo's boundary rows, ``halo.py``).
* ``max_over_ranks``: the elementwise maximum over the group; its backward
  raises ``NotImplementedError``, as JAX has no differentiation rule for
  ``pmax``.

A group of one rank, or ``None``, makes each of them the identity.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.autograd import Function


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


class _AllReduceSum(Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _SumOverRanks(Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Replicated(Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _MaxOverRanks(Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, op=dist.ReduceOp.MAX, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError(
            "the maximum over ranks has no backward (JAX: no "
            "differentiation rule for 'pmax'): a partitioned max or "
            "softmax aggregation trains on one rank only")


class _GatherShards(Function):
    @staticmethod
    def forward(ctx, shard, dim, group):
        n = dist.get_world_size(group)
        ctx.dim, ctx.n, ctx.index = dim, n, dist.get_rank(group)
        shard = shard.contiguous()
        parts = [torch.empty_like(shard) for _ in range(n)]
        dist.all_gather(parts, shard, group=group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.chunk(ctx.n, ctx.dim)[ctx.index].contiguous(), None, None


class _AllToAll(Function):
    @staticmethod
    def forward(ctx, x, group, pending):
        ctx.group = group
        out = torch.empty_like(x)
        pending.append(dist.all_to_all_single(out, x.contiguous(),
                                              group=group, async_op=True))
        return out

    @staticmethod
    def backward(ctx, grad):
        out = torch.empty_like(grad)
        dist.all_to_all_single(out, grad.contiguous(), group=ctx.group)
        return out, None, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    if group_size(group) == 1:
        return x
    return _AllReduceSum.apply(x, group)


def sum_over_ranks(x: torch.Tensor, group) -> torch.Tensor:
    if group_size(group) == 1:
        return x
    return _SumOverRanks.apply(x, group)


def replicated(x: torch.Tensor, group) -> torch.Tensor:
    if group_size(group) == 1:
        return x
    return _Replicated.apply(x, group)


def max_over_ranks(x: torch.Tensor, group) -> torch.Tensor:
    if group_size(group) == 1:
        return x
    return _MaxOverRanks.apply(x, group)


def gather_shards(shard: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' equal shards concatenated along ``dim``, in group-rank
    order."""
    if group_size(group) == 1:
        return shard
    return _GatherShards.apply(shard, dim, group)


def all_to_all_start(x: torch.Tensor, group):
    """(out, work): ``out[i]`` will hold rank i's ``x[me]`` once
    ``work.wait()`` has returned (x's leading dim is the group's size);
    read ``out`` only after that.  ``work`` is None for a group of one."""
    if group_size(group) == 1:
        return x, None
    pending = []
    out = _AllToAll.apply(x, group, pending)
    return out, pending[0]


def mean_over(x: torch.Tensor, group: Optional[object]) -> torch.Tensor:
    """The mean of a tensor over the group, without autograd (metrics)."""
    n = group_size(group)
    if n == 1:
        return x
    y = x.detach().contiguous().clone()
    dist.all_reduce(y, group=group)
    return y / n
