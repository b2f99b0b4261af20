"""The trainer's device mesh, with the JAX package's axis convention.

Port of the JAX package's ``parallel/mesh.py``. Axes:

- ``dp``: data parallelism; params and optimizer state are cut along each
  leaf's ``dp`` dim (``sharding.py``) and a pass gathers one layer at a
  time, the ZeRO-3 analogue;
- ``cp``: context parallelism; each rank holds a contiguous ``L/cp`` slice
  of the packed rows, and attention gathers K/V over the axis
  (``cp_attention.py``);
- ``tp`` and ``pp``: kept in ``AXES`` and ``infer_mesh_shape`` as JAX has
  them; a mesh with either above 1 raises (ROADMAP Queue 1, item 15).

JAX drives a whole mesh from one process; the port runs one rank process
per device, so ``make_mesh(dp, cp)`` needs a process group of ``dp * cp``
ranks (``multihost.maybe_initialize_distributed``). Global rank
``dp_rank * cp + cp_rank`` sits at mesh coordinate ``(dp_rank, cp_rank)``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

AXES = ("dp", "cp", "tp", "pp")
MESH_AXES = ("dp", "cp")


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


def refuse_tp_pp(tp: int = 1, pp: int = 1) -> None:
    for name, n in (("tp", tp), ("pp", pp)):
        if int(n) > 1:
            raise NotImplementedError(
                f"parallel.{name} > 1 is not ported yet: tensor and pipeline parallelism wait for "
                "ROADMAP Queue 1, item 15")


def make_mesh(dp: int, cp: int = 1, tp: int = 1, pp: int = 1) -> DeviceMesh:
    """A ``(dp, cp)`` DeviceMesh over the default process group, whose world
    size must be ``dp * cp``. Its device type is the backend's (gloo's
    ranks may share a card; the mesh only names their groups)."""
    refuse_tp_pp(tp, pp)
    world = dist.get_world_size()
    if dp * cp != world:
        raise ValueError(f"a ({dp}, {cp}) mesh needs {dp * cp} ranks, the world has {world}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.arange(world).reshape(dp, cp), mesh_dim_names=MESH_AXES)


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
