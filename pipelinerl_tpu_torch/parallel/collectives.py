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

Tensor parallelism (``TP``, a group of ranks that each hold a slice of
every layer's heads and FFN columns, and of the vocabulary) runs one loss
on every rank, the same on each, so its objective is that loss and not a
sum over ranks. Megatron's two operators carry it:

- ``copy_to_tp`` (Megatron's f): identity forward, all-reduce backward. A
  replicated activation that enters a rank's own columns (the inputs of
  the column-parallel ``wq/wk/wv/wgate/wup`` and of the vocabulary-split
  head; a log-normalizer the rank's own entropy terms read) gets every
  rank's share of its gradient;
- ``reduce_from_tp`` (Megatron's g): all-reduce forward, identity backward.
  The partial sums of the row-parallel ``wo`` and ``wdown``, and the
  vocabulary-parallel sums of the loss, become the replicated value whose
  gradient every rank already holds whole;
- ``count_once``: identity forward; the backward keeps the gradient on the
  group's first rank and zeroes it on the others. A replicated value read
  from a leaf that a later gather's reduce-scatter sums over the group (the
  embedding lookup from the gathered table) is then counted once.

Only calls that exist in torch 2.11 and 2.13 are used
(``all_gather_into_tensor`` and ``reduce_scatter_tensor``, which 2.13 marks
deprecated, and ``all_reduce``).
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Any

import torch
import torch.distributed as dist


def _size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


# -- plain (no autograd) forms ------------------------------------------------


def head_counts(num_heads: int, n: int) -> list[int]:
    """Query heads per tp rank, in contiguous blocks: the first
    ``num_heads % n`` ranks take one head more."""
    return [num_heads // n + (r < num_heads % n) for r in range(n)]


def gather(x: torch.Tensor, dim: int, group, sizes: list[int] | None = None) -> torch.Tensor:
    """The group's slices of ``x`` concatenated along ``dim``, rank order.
    ``sizes`` gives each rank's length along ``dim`` where they differ (a
    cut by whole heads): each slice is padded to the largest, gathered in
    one call, and trimmed."""
    n = _size(group)
    if n == 1:
        return x
    front = x.movedim(dim, 0).contiguous()
    width = max(sizes) if sizes else front.shape[0]
    if width != front.shape[0]:
        front = torch.cat([front, front.new_zeros((width - front.shape[0], *front.shape[1:]))])
    out = front.new_empty((n * width, *front.shape[1:]))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)  # 2.13's deprecation note
        dist.all_gather_into_tensor(out, front, group=group)
    if sizes and len(set(sizes)) > 1:
        out = torch.cat([piece[:size] for piece, size in zip(out.split(width), sizes)])
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


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return reduce_(grad.contiguous().clone(), ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _CountOnce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, first):
        ctx.first = first
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return (grad if ctx.first else torch.zeros_like(grad)), None


@dataclass(frozen=True)
class TP:
    """A tensor-parallel group: this rank's place in it and its size. The
    model reads its heads, FFN columns and vocabulary rows from ``rank``."""

    group: Any
    rank: int
    size: int


def copy_to_tp(x: torch.Tensor, tp: TP | None) -> torch.Tensor:
    """Megatron's f: identity forward, the gradient all-reduced over tp."""
    if tp is None or tp.size == 1 or not torch.is_grad_enabled():
        return x
    return _CopyToTP.apply(x, tp.group)


def reduce_from_tp(x: torch.Tensor, tp: TP | None) -> torch.Tensor:
    """Megatron's g: the tp group's sum forward, identity backward."""
    if tp is None or tp.size == 1:
        return x
    if not torch.is_grad_enabled():
        return reduce_(x.contiguous(), tp.group)
    return _ReduceFromTP.apply(x, tp.group)


def count_once(x: torch.Tensor, tp: TP | None) -> torch.Tensor:
    """Identity forward; the gradient kept on tp rank 0 and zeroed on the
    others."""
    if tp is None or tp.size == 1 or not torch.is_grad_enabled():
        return x
    return _CountOnce.apply(x, tp.rank == 0)


def max_over_tp(x: torch.Tensor, tp: TP | None) -> torch.Tensor:
    """The group's elementwise maximum of ``x`` (no gradient: callers
    detach it, as logsumexp's shift)."""
    if tp is None or tp.size == 1:
        return x
    return reduce_(x.detach().contiguous().clone(), tp.group, dist.ReduceOp.MAX)


def gather_vocab(logits: torch.Tensor, tp: TP | None) -> torch.Tensor:
    """The whole vocabulary's logits from each rank's ``V/tp`` columns (the
    last dim), in rank order; no gradient."""
    if tp is None or tp.size == 1:
        return logits
    return gather(logits.contiguous(), logits.ndim - 1, tp.group)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The group's sum of ``x``, whose backward sums the gradient over the
    group."""
    if _size(group) == 1:
        return x
    return _AllReduceSum.apply(x, group)
