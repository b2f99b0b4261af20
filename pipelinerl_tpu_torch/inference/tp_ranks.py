"""A tensor-parallel engine: ``engine.tp`` rank processes in lockstep.

Port of the JAX engine's ``tp`` (``EngineConfig.tp``, the reference's vLLM
``tensor-parallel-size``). JAX shards the params and the KV cache over a
tp mesh and GSPMD inserts the collectives into its jitted programs; the
port runs one process per rank, each holding its slice of the weights
(``parallel.sharding.tp_local``) and a cache of its KV heads, and runs
Megatron's splits in ``models/transformer.py``, whose all-reduces go over
the engine world's default group.

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
- Every rank ends a step with the same tokens: the fp32 logits of each
  rank's vocabulary rows are all-gathered over tp and the unchanged
  sampler runs on every rank with the same ``torch.Generator`` seed, so
  the tp 1 sampler, and the logprob of log softmax(logits / T) from an
  fp32 unembed, hold as they are.
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

logger = logging.getLogger(__name__)

# the control and push groups wait as long as the engine idles
IDLE_TIMEOUT = timedelta(days=30)


@dataclass
class EngineWorld:
    """An engine's tp ranks: this rank's place, the decode group (the
    default group of the engine's processes), and the two gloo groups of
    the lockstep commands and the pushes."""

    rank: int
    size: int
    group: Any
    control: Any
    push: Any

    @property
    def tp(self) -> TP:
        return TP(self.group, self.rank, self.size)


def join_engine_world(rank: int, size: int, coordinator: str, device: torch.device) -> EngineWorld:
    """Join the engine's tp world at ``coordinator`` (``host:port``):
    NCCL when each rank of this host owns a card (``LOCAL_WORLD_SIZE``
    engine ranks, the launcher's), gloo on the CPU and where ranks share a
    card."""
    from ..parallel.multihost import choose_backend

    if not dist.is_initialized():
        backend = choose_backend(int(os.environ.get("LOCAL_WORLD_SIZE", size)), device)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group(backend, init_method=f"tcp://{coordinator}", rank=rank, world_size=size)
        logger.info("engine tp world: backend %s, rank %d/%d on %s", backend, rank, size, device)
    control = dist.new_group(backend="gloo", timeout=IDLE_TIMEOUT)
    push = dist.new_group(backend="gloo", timeout=IDLE_TIMEOUT)
    return EngineWorld(rank, size, dist.group.WORLD, control, push)


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
