"""The trainer's device mesh, with the JAX package's axis convention.

Port of the JAX package's ``parallel/mesh.py``. Axes:

- ``dp``: data parallelism; params and optimizer state are cut along each
  leaf's ``dp`` dim (``sharding.py``) and a pass gathers one layer at a
  time, the ZeRO-3 analogue;
- ``cp``: context parallelism; each rank holds a contiguous ``L/cp`` slice
  of the packed rows, and attention gathers K/V over the axis
  (``cp_attention.py``);
- ``tp``: tensor parallelism; each rank holds its slice of every layer's
  heads and FFN columns (Megatron's column- and row-parallel splits,
  ``models/transformer.py``) and computes the logits of its ``V/tp``
  vocabulary rows;
- ``pp``: kept in ``AXES`` and ``infer_mesh_shape`` as JAX has it. The
  trainer's mesh has no pp axis, as the JAX trainer's has none
  (``parallel.pp`` is not read). An engine's pipeline stages are ranks of
  the engine's own world (``engine_layout``, ``inference/tp_ranks.py``).

JAX drives a whole mesh from one process; the port runs one rank process
per device, so ``make_mesh(dp, cp, tp)`` needs a process group of
``dp * cp * tp`` ranks (``multihost.maybe_initialize_distributed``). Global
rank ``(dp_rank * cp + cp_rank) * tp + tp_rank`` sits at mesh coordinate
``(dp_rank, cp_rank, tp_rank)``: tp innermost, so tp peers sit on
neighbouring cards.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .collectives import TP, reduce_

AXES = ("dp", "cp", "tp", "pp")
MESH_AXES = ("dp", "cp", "tp")


def infer_mesh_shape(
    n_devices: int, tp: int | None = None, cp: int | None = None,
    pp: int | None = None,
) -> tuple[int, int, int, int]:
    """Choose (dp, cp, tp, pp) for n_devices. Explicit tp/cp/pp are honored;
    the rest goes to dp."""
    tp = tp or 1
    cp = cp or 1
    pp = pp or 1
    if n_devices % (tp * cp * pp) != 0:
        raise ValueError(
            f"{n_devices} devices not divisible by tp*cp*pp={tp * cp * pp}"
        )
    return (n_devices // (tp * cp * pp), cp, tp, pp)


def check_pp_layers(num_layers: int, pp: int) -> None:
    """The stacked layers must split into ``pp`` equal stages (JAX's
    engine raises the same)."""
    if num_layers % pp:
        raise ValueError(f"num_layers {num_layers} not divisible by pp={pp}")


def engine_layout(rank: int, tp: int, pp: int) -> tuple[int, int]:
    """(stage, tp rank) of an engine world's rank: ``rank = stage·tp +
    tp_rank``, a tp group per stage and a pp group per tp rank."""
    if not 0 <= rank < tp * pp:
        raise ValueError(f"engine rank {rank} outside a world of tp*pp={tp * pp}")
    return rank // tp, rank % tp


def engine_groups(tp: int, pp: int) -> tuple[list[list[int]], list[list[int]]]:
    """The ranks of each stage's tp group, and of each pp group (one per
    tp rank, in stage order)."""
    return ([[s * tp + t for t in range(tp)] for s in range(pp)],
            [[s * tp + t for s in range(pp)] for t in range(tp)])


def make_mesh(dp: int, cp: int = 1, tp: int = 1) -> DeviceMesh:
    """A ``(dp, cp, tp)`` DeviceMesh over the default process group, whose
    world size must be ``dp * cp * tp``. Its device type is the backend's
    (gloo's ranks may share a card; the mesh only names their groups)."""
    world = dist.get_world_size()
    if dp * cp * tp != world:
        raise ValueError(f"a ({dp}, {cp}, {tp}) mesh needs {dp * cp * tp} ranks, the world has {world}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.arange(world).reshape(dp, cp, tp), mesh_dim_names=MESH_AXES)


def axis_size(mesh: DeviceMesh | None, name: str) -> int:
    return 1 if mesh is None else mesh.size(MESH_AXES.index(name))


def axis_rank(mesh: DeviceMesh | None, name: str) -> int:
    return 0 if mesh is None else mesh.get_local_rank(name)


def axis_group(mesh: DeviceMesh | None, name: str):
    """The process group of this rank's ``name`` axis, or None (one rank)."""
    if axis_size(mesh, name) == 1:
        return None
    return mesh.get_group(name)


def world_group(mesh: DeviceMesh | None):
    """The default group when the mesh spans more than one rank, else None."""
    return None if mesh is None or mesh.size() == 1 else dist.group.WORLD


def reduce_over(x: torch.Tensor, mesh: DeviceMesh | None, axes, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """All-reduce ``x`` in place over each of ``axes`` in turn (their
    product group); returns it."""
    for name in axes:
        reduce_(x, axis_group(mesh, name), op)
    return x


def tp_context(mesh: DeviceMesh | None):
    """The model's ``collectives.TP`` of this rank's tp axis, or None."""
    n = axis_size(mesh, "tp")
    return None if n == 1 else TP(axis_group(mesh, "tp"), axis_rank(mesh, "tp"), n)
