"""The collectives of the trainer world, and their autograd rules.

Each call skips a group of one rank. NCCL, and gloo in torch 2.11 and
2.13, take CUDA tensors for the three calls used here (``chip_smoke.py``
phase 27 (a) asks gloo on the card), so no call stages through host
memory.

The autograd rules make the sum of every rank's local loss the objective:

- ``all_gather`` (along any dim): its backward reduce-scatters (sums) the
  gathered gradient back onto each rank's slice. This is the dp gather of
  the sharded params and the cp gather of K/V.
- ``all_reduce_sum``: its backward all-reduces (sums) the gradient, so a
  quantity every rank computes from the group's sum gets each rank's share
  of the gradient. GSPO's segment sums under cp take it.

Only calls that exist in torch 2.11 and 2.13 are used
(``all_gather_into_tensor`` and ``reduce_scatter_tensor``, which 2.13 marks
deprecated, and ``all_reduce``).
"""

from __future__ import annotations

import warnings

import torch
import torch.distributed as dist


def _size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


# -- plain (no autograd) forms ------------------------------------------------


def gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's slices of ``x`` concatenated along ``dim``, rank order."""
    n = _size(group)
    if n == 1:
        return x
    front = x.movedim(dim, 0).contiguous()
    out = front.new_empty((n * front.shape[0], *front.shape[1:]))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)  # 2.13's deprecation note
        dist.all_gather_into_tensor(out, front, group=group)
    return out.movedim(0, dim)


def scatter_sum(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's sum of ``x``, cut along ``dim``; this rank's piece."""
    n = _size(group)
    if n == 1:
        return x
    front = x.movedim(dim, 0).contiguous()
    out = front.new_empty((front.shape[0] // n, *front.shape[1:]))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)  # 2.13's deprecation note
        dist.reduce_scatter_tensor(out, front, group=group)
    return out.movedim(0, dim)


def reduce_(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """All-reduce ``x`` in place; returns it."""
    if _size(group) > 1:
        dist.all_reduce(x, op=op, group=group)
    return x


# -- autograd forms -----------------------------------------------------------


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return gather(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return scatter_sum(grad, ctx.dim, ctx.group), None, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return reduce_(grad.contiguous().clone(), ctx.group), None


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """``gather`` whose backward reduce-scatters the gradient over the
    group."""
    if _size(group) == 1:
        return x
    return _AllGather.apply(x, dim, group)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The group's sum of ``x``, whose backward sums the gradient over the
    group."""
    if _size(group) == 1:
        return x
    return _AllReduceSum.apply(x, group)
