"""Joining the trainer world (``torch.distributed``) and its mesh.

Port of the JAX package's ``parallel/multihost.py``. JAX runs one process
per host that sees the host's chips; the port runs one rank process per
device. ``maybe_initialize_distributed`` reads the rank, the world size and
the coordinator from the job's ``me`` settings (``process_id``,
``num_processes``, ``coordinator``, which ``world.WorldMap`` gives every
trainer job) or from the environment (``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``/``MASTER_PORT``, or the JAX package's ``JAX_*`` names), and
stays inert with one process.

The backend follows from placement: ``nccl`` when every rank owns its
device; ``gloo`` on the CPU and where ranks share one device (NCCL refuses
two ranks on one GPU).

A gloo world on the CPU, one process per rank (``run_world`` starts them,
as the tests do)::

    python -m pipelinerl_tpu_torch.parallel.multihost <module:function> <world> [json kwargs]
"""

from __future__ import annotations

import json
import logging
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch
import torch.distributed as dist

from .mesh import make_mesh

logger = logging.getLogger(__name__)


def _setting(cfg, key: str, *env: str):
    me = cfg.select(f"me.{key}") if cfg is not None and hasattr(cfg, "select") else None
    if me is not None:
        return me
    return next((os.environ[e] for e in env if os.environ.get(e)), None)


def world_settings(cfg=None) -> tuple[int, int, str | None]:
    """(rank, world size, coordinator ``host:port``) of this process."""
    rank = int(_setting(cfg, "process_id", "RANK", "JAX_PROCESS_ID") or 0)
    world = int(_setting(cfg, "num_processes", "WORLD_SIZE", "JAX_NUM_PROCESSES") or 1)
    coordinator = _setting(cfg, "coordinator", "JAX_COORDINATOR_ADDRESS")
    if coordinator is None and os.environ.get("MASTER_ADDR"):
        coordinator = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
    return rank, world, coordinator


def rank_device(rank: int, device: str = "cuda") -> torch.device:
    """``cuda:(local_rank % device_count)``, the card named (``cuda:<n>``,
    the launcher's slot), or the CPU when asked."""
    if str(device) == "cpu" or ":" in str(device):
        return torch.device(device)
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % torch.cuda.device_count())


def choose_backend(world: int, device: torch.device) -> str:
    """``nccl`` when every rank of this host owns a device, else ``gloo``."""
    if device.type != "cuda":
        return "gloo"
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    return "nccl" if local_world <= torch.cuda.device_count() else "gloo"


def maybe_initialize_distributed(cfg=None, device: str = "cuda") -> tuple[bool, torch.device]:
    """Join the trainer world when it has more than one rank; → (joined,
    this rank's device). Inert with one process, and when the default group
    already exists."""
    rank, world, coordinator = world_settings(cfg)
    dev = rank_device(rank, device)
    if world <= 1 or dist.is_initialized():
        return dist.is_initialized(), dev
    if not coordinator:
        raise ValueError("a trainer world of more than one rank needs a coordinator host:port")
    backend = choose_backend(world, dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}", rank=rank, world_size=world)
    logger.info("trainer world: backend %s, rank %d/%d on %s", backend, rank, world, dev)
    return True, dev


def make_multihost_mesh(dp: int, cp: int = 1, tp: int = 1):
    """The (dp, cp, tp) mesh with cp x tp confined to each host's ranks and
    dp spanning hosts, as JAX's check asks: cp * tp must divide the ranks of
    a host."""
    local = int(os.environ.get("LOCAL_WORLD_SIZE", dist.get_world_size()))
    if local % (cp * tp) != 0:
        raise ValueError(f"cp*tp={cp * tp} must divide the local rank count {local} "
                         "(cp and tp collectives stay within a host)")
    return make_mesh(dp, cp, tp)


# -- a gloo world of processes on one host (tests, CPU runs) ------------------


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_world(target: str, world: int, kwargs: dict, timeout: float = 120.0, cwd: str | None = None,
              pythonpath: list[str] | None = None) -> None:
    """Run ``module:function(rank, world, **kwargs)`` in ``world`` CPU
    processes joined in one gloo group (one torch thread each); raise when
    a rank fails or outlives ``timeout`` seconds."""
    port = str(free_port())
    root = str(Path(__file__).resolve().parents[2])
    env = dict(os.environ, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.pathsep.join([root, *(pythonpath or []), os.environ.get("PYTHONPATH", "")]))
    procs, logs = [], []
    deadline = time.monotonic() + timeout
    try:
        for rank in range(world):
            env_r = dict(env, RANK=str(rank), WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1", MASTER_PORT=port)
            logs.append(tempfile.TemporaryFile("w+"))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "pipelinerl_tpu_torch.parallel.multihost", target, str(world),
                 json.dumps(kwargs)], env=env_r, cwd=cwd, stdout=logs[-1], stderr=subprocess.STDOUT))
        # a rank that fails leaves its peers blocked in a collective: stop
        # them at once
        while any(p.poll() is None for p in procs) and time.monotonic() < deadline:
            if any(p.returncode for p in procs):
                break
            time.sleep(0.05)
        failed = []
        for rank, (p, log) in enumerate(zip(procs, logs)):
            if p.poll() is None or p.returncode:
                log.seek(0)
                state = "timed out" if p.poll() is None else f"exited {p.returncode}"
                failed.append(f"rank {rank} {state}:\n{log.read()[-4000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    if failed:
        raise RuntimeError("\n".join(failed))


def _rank_main(argv: list[str]) -> None:
    import importlib

    target, world = argv[0], int(argv[1])
    kwargs = json.loads(argv[2]) if len(argv) > 2 else {}
    torch.set_num_threads(1)
    maybe_initialize_distributed(device="cpu")
    module, fn = target.split(":")
    getattr(importlib.import_module(module), fn)(dist.get_rank() if world > 1 else 0, world, **kwargs)
    leave_world()  # a rank that raised exits at once instead


def leave_world() -> None:
    """Wait for every rank, then leave: rank 0 hosts the group's store, so
    it must not go while another rank still talks to it."""
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main(sys.argv[1:])
