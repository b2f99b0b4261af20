"""A tensor- and pipeline-parallel engine: ``engine.tp * engine.pp`` rank
processes in lockstep.

Port of the JAX engine's ``tp`` and ``pp`` (``EngineConfig.tp``/``pp``, the
reference's vLLM ``tensor-parallel-size`` and ``pipeline-parallel-size``).
JAX shards the params and the KV cache over a ``(tp, pp)`` mesh and GSPMD
inserts the collectives into its jitted programs, moving the activations
stage to stage inside the layer scan; the port runs one process per rank,
``rank = stage·tp + tp_rank`` (``parallel.mesh.engine_layout``). Each rank
holds its stage's layers (``parallel.sharding.pp_local``: the embedding
table on the first stage, the final norm and head on the last) cut to its
tp slice (``tp_local``), and a cache of its stage's layers and its KV
heads; it runs Megatron's splits in ``models/transformer.py``, whose
all-reduces go over its stage's tp group (the default group at pp 1).

- Rank 0 owns the scheduler, the HTTP server and the transfer thread. At
  the start of each engine step that has work it broadcasts one command
  over a gloo group of its own (``control``): the requests submitted
  since the last step, the aborts, the weight version to swap in, and the
  jobs that must run on every rank (``score_tokens``, the ranks' weight
  checksums). Every rank then runs the same step on its shards: the same
  admissions, prefill and extend batches, forks, window sizes, swaps and
  aborts, since the scheduler is a deterministic function of its inputs.
- Ranks above 0 run ``InferenceEngine.serve_tp_worker``: receive a
  command, apply it, step. Their futures resolve unread.
- At pp above 1, each forward runs stage by stage: a stage's hidden state
  (``[S, D]`` a decode step, ``[B, Lb, D]`` a prefill) goes to the same tp
  rank of the next stage (``send_hidden``/``recv_hidden``, a broadcast in
  the two ranks' own group, which only the decode thread uses), and each
  stage waits for the one before, as JAX's layer scan does (no
  microbatches).
- Every rank ends a step with the same tokens: the fp32 logits of each
  last-stage rank's vocabulary rows are all-gathered over tp and the
  unchanged sampler runs there with the one-rank engine's
  ``torch.Generator`` seed, so the tp 1 sampler, and the logprob of log
  softmax(logits / T) from an fp32 unembed, hold as they are. At pp above
  1 the last stage's tokens and logprobs then go to every rank
  (``share_sampled``, over the default group): the first stage embeds
  them at the next step, and every scheduler reads them back.
- Pushes take the tree path, as the JAX engine's tp pushes do: rank 0's
  transfer thread broadcasts the PWT3 body over a third gloo group
  (``push``, never used by a decode step: collectives on one group must
  come in one order on every rank, and pushes run on their own threads),
  each rank cuts and stages its slice while decoding goes on, and once
  every rank holds it (an all-reduce on ``push``) rank 0 publishes the
  version; the swap rides the next command. A push never pauses
  decoding.
"""

from __future__ import annotations

import logging
import os
from concurrent.futures import Future
from dataclasses import dataclass
from datetime import timedelta
from typing import Any

import torch
import torch.distributed as dist

from ..parallel.collectives import TP
from ..parallel.mesh import engine_groups, engine_layout

logger = logging.getLogger(__name__)

# the control and push groups wait as long as the engine idles
IDLE_TIMEOUT = timedelta(days=30)


@dataclass
class EngineWorld:
    """An engine's ranks: this rank's place among ``size`` ranks of ``pp``
    stages, its stage's tp group (``group``), the two gloo groups of the
    lockstep commands and the pushes, and at pp above 1 the groups of the
    stage hand-offs (this rank and its tp peer on the stage before,
    ``prev``, and after, ``next``) and of the sampled tokens' return (the
    default group, ``results``)."""

    rank: int
    size: int
    group: Any
    control: Any
    push: Any
    pp: int = 1
    prev: Any = None
    next: Any = None
    results: Any = None

    @property
    def tp_size(self) -> int:
        return self.size // self.pp

    @property
    def stage(self) -> int:
        return engine_layout(self.rank, self.tp_size, self.pp)[0]

    @property
    def first(self) -> bool:
        return self.stage == 0

    @property
    def last(self) -> bool:
        return self.stage == self.pp - 1

    @property
    def tp(self) -> TP:
        return TP(self.group, engine_layout(self.rank, self.tp_size, self.pp)[1], self.tp_size)


def join_engine_world(rank: int, size: int, coordinator: str, device: torch.device, pp: int = 1) -> EngineWorld:
    """Join the engine's world of ``size`` ranks (``pp`` stages of
    ``size / pp`` tp ranks) at ``coordinator`` (``host:port``): NCCL when
    each rank of this host owns a card (``LOCAL_WORLD_SIZE`` engine ranks,
    the launcher's), gloo on the CPU and where ranks share a card. Every
    rank makes every group, in one order."""
    from ..parallel.multihost import choose_backend

    if size % pp:
        raise ValueError(f"an engine world of {size} ranks does not split into pp={pp} stages")
    if not dist.is_initialized():
        backend = choose_backend(int(os.environ.get("LOCAL_WORLD_SIZE", size)), device)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group(backend, init_method=f"tcp://{coordinator}", rank=rank, world_size=size)
        logger.info("engine world: backend %s, rank %d/%d (pp %d) on %s", backend, rank, size, pp, device)
    control = dist.new_group(backend="gloo", timeout=IDLE_TIMEOUT)
    push = dist.new_group(backend="gloo", timeout=IDLE_TIMEOUT)
    if pp == 1:
        return EngineWorld(rank, size, dist.group.WORLD, control, push)
    tp = size // pp
    stages, pipes = engine_groups(tp, pp)
    group = None
    for ranks in stages:
        made = dist.new_group(ranks)
        group = made if rank in ranks else group
    prev = nxt = None
    for pipe in pipes:
        for a, b in zip(pipe, pipe[1:]):
            made = dist.new_group([a, b])
            prev = made if rank == b else prev
            nxt = made if rank == a else nxt
    return EngineWorld(rank, size, group, control, push, pp=pp, prev=prev, next=nxt, results=dist.group.WORLD)


def send_hidden(world: EngineWorld, x: torch.Tensor) -> None:
    """A stage's hidden state to the same tp rank of the next stage."""
    dist.broadcast(x.contiguous(), src=world.rank, group=world.next)


def recv_hidden(world: EngineWorld, shape: tuple, dtype: torch.dtype, device) -> torch.Tensor:
    """The previous stage's hidden state of ``shape``, from this rank's tp
    peer there."""
    x = torch.empty(shape, dtype=dtype, device=device)
    dist.broadcast(x, src=world.rank - world.tp_size, group=world.prev)
    return x


def share_from_last(world: EngineWorld, x: torch.Tensor | None, shape: tuple, dtype: torch.dtype,
                    device) -> torch.Tensor:
    """The last stage's ``x`` (every last-stage rank holds the same) on
    every rank; the other stages pass None."""
    if x is None:
        x = torch.empty(shape, dtype=dtype, device=device)
    dist.broadcast(x.contiguous(), src=(world.pp - 1) * world.tp_size, group=world.results)
    return x


def share_sampled(world: EngineWorld, tokens: torch.Tensor | None, logprobs: torch.Tensor | None, n: int,
                  device) -> tuple[torch.Tensor, torch.Tensor]:
    """The last stage's sampled ``tokens`` [n] and fp32 ``logprobs`` [n] on
    every rank, in one int32 [2, n] broadcast."""
    packed = None
    if tokens is not None:
        packed = torch.stack([tokens.to(torch.int32), logprobs.float().view(torch.int32)])
    packed = share_from_last(world, packed, (2, n), torch.int32, device)
    return packed[0].to(torch.int64), packed[1].view(torch.float32)


def send_command(world: EngineWorld, cmd) -> None:
    """Rank 0: one step's command (None stops the workers)."""
    box = [cmd]
    dist.broadcast_object_list(box, src=0, group=world.control)


def receive_command(world: EngineWorld):
    box = [None]
    dist.broadcast_object_list(box, src=0, group=world.control)
    return box[0]


def gather_to_rank0(world: EngineWorld, obj) -> list | None:
    """Every rank's ``obj``, on rank 0 (None elsewhere), over ``control``."""
    out = [None] * world.size if world.rank == 0 else None
    dist.gather_object(obj, out, dst=0, group=world.control)
    return out


def send_push(world: EngineWorld, body, version: int) -> None:
    """Rank 0's transfer thread: a PWT3 body to every rank (``body`` None
    stops their receivers)."""
    from .weight_transfer import byte_view

    size = -1 if body is None else len(body)
    dist.broadcast(torch.tensor([size, version], dtype=torch.int64), src=0, group=world.push)
    if body is not None:
        dist.broadcast(byte_view(body).clone(), src=0, group=world.push)


def receive_push(world: EngineWorld):
    """A worker's receiver: → (body as a uint8 tensor, version), or None
    once rank 0 stops."""
    head = torch.empty(2, dtype=torch.int64)
    dist.broadcast(head, src=0, group=world.push)
    size, version = (int(x) for x in head)
    if size < 0:
        return None
    body = torch.empty(size, dtype=torch.uint8)
    dist.broadcast(body, src=0, group=world.push)
    return body, version


def all_staged(world: EngineWorld, ok: bool) -> bool:
    """Whether every rank staged its slice of a push."""
    flag = torch.tensor([1 if ok else 0], dtype=torch.int64)
    dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=world.push)
    return bool(flag.item())


def resolved_future() -> Future:
    """A worker's future: running, resolved by the engine and never read."""
    future: Future = Future()
    future.set_running_or_notify_cancel()
    return future
