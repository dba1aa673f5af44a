"""Collectives of the sharded step, with the gradients JAX derives for them.

Under ``shard_map`` JAX transposes each collective for its backward pass
(all_to_all to the reverse all_to_all, all_gather to psum_scatter, psum of
a result every device holds to a broadcast).  The port writes those rules
as ``torch.autograd.Function``\\ s:

- :func:`all_to_all`: chunk j of dim 0 goes to group rank j; its backward
  is the same exchange of the gradients;
- :func:`all_gather`: every rank's tensor stacked on a new dim 0; its
  backward hands each rank the sum over ranks of the gradient of its own
  slice;
- :func:`sum_replicated`: the sum over the group of a tensor whose result
  every rank then uses identically (the merged image of the partials
  strategy); its backward is the identity, since each rank holds the same
  gradient of that shared result and counts it once.

Every sum over ranks is an all-gather followed by a sum in rank order on
each rank, never a backend's all-reduce, so it repeats bit for bit and
every rank gets the same bits whatever the host split.  All of these must
be called by every rank of ``group``, in the same order, forward and
backward.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def ordered_sum(stacked: torch.Tensor) -> torch.Tensor:
    """Sum over dim 0 in index order: ((x0 + x1) + x2) + …"""
    out = stacked[0].clone()
    for x in stacked[1:]:
        out = out + x
    return out


def gather(x: torch.Tensor, group) -> torch.Tensor:
    """[K, *x.shape]: every group rank's ``x`` in rank order (no gradient)."""
    k = dist.get_world_size(group)
    flat = x.reshape(-1).contiguous()
    out = flat.new_empty(k * flat.numel())
    # all_gather_single is the newer name of all_gather_into_tensor
    getattr(dist, "all_gather_single", dist.all_gather_into_tensor)(
        out, flat, group=group)
    return out.view((k,) + tuple(x.shape))


def _exchange(x: torch.Tensor, group) -> torch.Tensor:
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x.contiguous(), group=group)
    return out


def gather_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the group, in rank order (no gradient)."""
    return ordered_sum(gather(x, group))


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return gather(x, group)

    @staticmethod
    def backward(ctx, g):
        # row j of every rank's gradient goes to rank j, which sums them
        return ordered_sum(_exchange(g, ctx.group)), None


class _SumReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return gather_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Exchange the K chunks of dim 0 (``x.shape[0]`` = group size): the
    result's chunk p is what rank p sent to this rank."""
    return _AllToAll.apply(x, group)


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """[K, *x.shape], differentiable: see the module docstring."""
    return _AllGather.apply(x, group)


def sum_replicated(x: torch.Tensor, group) -> torch.Tensor:
    """The group sum of ``x`` for a result every rank uses identically."""
    return _SumReplicated.apply(x, group)
