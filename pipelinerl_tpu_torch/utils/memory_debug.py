"""Memory snapshots and a step profiler at named trainer phases.

Port of the JAX package's ``utils/memory_debug.py``: JSONL memory records at
the trainer's phase hooks, gated by ``finetune.memory_debug.*``, and a
trace of a configured step range, gated by ``finetune.profile.*``::

    finetune:
      memory_debug: {enabled: true, every_n: 1}
      profile: {enabled: true, start_step: 10, num_steps: 3}

A record holds JAX's keys: ``ts``, ``phase``, ``step``, ``pid``, the host's
``vmrss``/``vmhwm`` (``/proc/self/status``) and cgroup readings, then
``device_<i>`` (``bytes_in_use``, ``peak_bytes_in_use``, ``bytes_limit``)
for the rank's own card only (asking about the others would open a CUDA
context on every card of a multi-rank world), then ``live_arrays`` and
``live_array_bytes``, then the caller's extras. On a card those two read
the caching allocator: its active blocks and their bytes
(``torch.cuda.memory_stats`` ``active.all.current``,
``active_bytes.all.current``); on the CPU, a census of the tensors the
garbage collector can reach (distinct storages, and their bytes).
``bytes_limit`` is the card's total memory (``torch.cuda.mem_get_info``).

The profiler wraps the steps in ``torch.profiler.profile`` (CPU activity,
plus CUDA on a card) and writes a TensorBoard-readable trace with
``tensorboard_trace_handler`` under ``<exp>/profile``, the rank in the
worker name. On a card a trace without device events raises: a CPU-only
trace would hide the device. The trace starts and stops under ``quiesce``
(a context in which no other thread of the process launches on the card:
an inline run's engine thread): CUPTI's start and teardown raced the
engine thread's launches and crashed the process (SIGSEGV at the trace's
stop, the engine thread mid-decode).
"""

from __future__ import annotations

import contextlib
import gc
import json
import logging
import os
import sys
import time
from pathlib import Path
from typing import Any, Callable, ContextManager

import torch

logger = logging.getLogger(__name__)


def _host_memory() -> dict[str, int]:
    out: dict[str, int] = {}
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith(("VmRSS:", "VmHWM:")):
                    key, value = line.split(":", 1)
                    out[key.lower()] = int(value.strip().split()[0]) * 1024
    except OSError:
        pass
    for path, key in (
        ("/sys/fs/cgroup/memory.current", "cgroup_v2_current"),
        ("/sys/fs/cgroup/memory/memory.usage_in_bytes", "cgroup_v1_usage"),
    ):
        try:
            out[key] = int(Path(path).read_text().strip())
        except (OSError, ValueError):
            pass
    return out


def _tensor_census() -> tuple[int, int]:
    """(distinct storages, their bytes) of the CPU tensors the garbage
    collector reaches. ``gc.get_objects()`` also returns what other threads
    are still building, such as a tuple that ``tuple(generator)`` will
    resize, which raises ``SystemError`` once a second reference exists: the
    walk keeps the GIL (no forced hand-off) until only the tensors are held,
    so no other thread runs while it holds the rest."""
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e6)
    try:
        objects = gc.get_objects()
        tensors = [obj for obj in objects if issubclass(type(obj), torch.Tensor)]
        del objects
    finally:
        sys.setswitchinterval(switch)
    seen: dict[int, int] = {}
    for obj in tensors:
        if obj.device.type == "cpu" and obj.layout == torch.strided:
            storage = obj.untyped_storage()
            seen[storage.data_ptr()] = storage.nbytes()
    return len(seen), sum(seen.values())


def _device_memory(device: torch.device | None) -> dict[str, Any]:
    out: dict[str, Any] = {}
    if device is not None and device.type == "cuda":
        index = device.index if device.index is not None else torch.cuda.current_device()
        stats = torch.cuda.memory_stats(index)
        _, total = torch.cuda.mem_get_info(index)
        out[f"device_{index}"] = {
            "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
            "bytes_limit": int(total),
        }
        out["live_arrays"] = int(stats.get("active.all.current", 0))
        out["live_array_bytes"] = int(stats.get("active_bytes.all.current", 0))
    else:
        out["live_arrays"], out["live_array_bytes"] = _tensor_census()
    return out


class MemoryDebugger:
    """JSONL memory snapshots at named phases (one file per rank)."""

    def __init__(self, out_path: str | Path, rank: int = 0, every_n: int = 1, device: torch.device | None = None):
        self.path = Path(out_path) / f"memory_debug_{rank}.jsonl"
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.every_n = max(1, every_n)
        self.device = torch.device(device) if device is not None else None
        self._counts: dict[str, int] = {}
        self._fh = open(self.path, "a", buffering=1)

    def snapshot(self, phase: str, step: int | None = None, **extra: Any) -> None:
        count = self._counts.get(phase, 0)
        self._counts[phase] = count + 1
        if count % self.every_n:
            return
        record = {
            "ts": time.time(),
            "phase": phase,
            "step": step,
            "pid": os.getpid(),
            **_host_memory(),
            **_device_memory(self.device),
            **extra,
        }
        self._fh.write(json.dumps(record) + "\n")

    def close(self) -> None:
        self._fh.close()


class NullDebugger:
    def snapshot(self, phase: str, step: int | None = None, **extra: Any) -> None:
        pass

    def close(self) -> None:
        pass


def create_memory_debugger(cfg: Any, exp_path: str, rank: int = 0, device: torch.device | None = None):
    """A ``MemoryDebugger`` writing ``<exp>/metrics/memory_debug_<rank>.jsonl``
    when ``finetune.memory_debug.enabled``, else a ``NullDebugger``."""
    md = cfg.select("finetune.memory_debug") if hasattr(cfg, "select") else None
    if not md or not md.get("enabled", False):
        return NullDebugger()
    return MemoryDebugger(Path(exp_path) / "metrics", rank=rank, every_n=int(md.get("every_n", 1)), device=device)


class StepProfiler:
    """Wraps steps [start_step, start_step + num_steps) in a
    ``torch.profiler`` trace; the TensorBoard-readable trace lands in
    ``out_dir`` as ``rank<rank>.<time>.pt.trace.json``."""

    def __init__(self, out_dir: str | Path, start_step: int, num_steps: int, rank: int = 0,
                 device: torch.device | None = None, quiesce: Callable[[], ContextManager] | None = None):
        self.out_dir = str(out_dir)
        self.quiesce = quiesce or contextlib.nullcontext
        self.start_step = start_step
        self.stop_step = start_step + num_steps
        self.rank = rank
        self.device = torch.device(device) if device is not None else torch.device("cpu")
        self.active = False
        self._prof = None
        self.trace_path: Path | None = None
        self.export_s = 0.0

    def on_step(self, step: int) -> None:
        if not self.active and step == self.start_step:
            Path(self.out_dir).mkdir(parents=True, exist_ok=True)
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(
                activities=activities,
                on_trace_ready=torch.profiler.tensorboard_trace_handler(self.out_dir, worker_name=f"rank{self.rank}"))
            with self.quiesce():
                self._prof.start()
            self.active = True
            logger.info("torch profiler trace started (steps %d..%d) -> %s",
                        self.start_step, self.stop_step - 1, self.out_dir)
        elif self.active and step >= self.stop_step:
            self.stop()

    def stop(self, check: bool = True) -> None:
        """End the trace and write it. With ``check`` a missing trace, or one
        with no device event on a card, raises; without it (the trainer
        stopping on an error, which must not be masked) it is logged."""
        if not self.active:
            return
        self.active = False
        before = set(Path(self.out_dir).glob(f"rank{self.rank}.*.pt.trace.json"))
        with self.quiesce():
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            t0 = time.monotonic()
            self._prof.stop()  # calls the trace handler, which writes the file
            self.export_s = time.monotonic() - t0
        written = sorted(set(Path(self.out_dir).glob(f"rank{self.rank}.*.pt.trace.json")) - before)
        self.trace_path = written[-1] if written else None
        device_events = 0
        if self.device.type == "cuda":
            device_events = sum(1 for e in self._prof.profiler.kineto_results.events()
                                if e.device_type() == torch.autograd.DeviceType.CUDA)
        self._prof = None
        logger.info("torch profiler trace written to %s in %.1f s (%d device events)", self.trace_path,
                    self.export_s, device_events)
        fault = None
        if self.trace_path is None:
            fault = f"the profiler wrote no trace under {self.out_dir}"
        elif self.device.type == "cuda" and not device_events:
            fault = f"the profiler's trace {self.trace_path} holds no device events: CUPTI did not trace {self.device}"
        if fault and check:
            raise RuntimeError(fault)
        if fault:
            logger.error(fault)


class NullProfiler:
    def on_step(self, step: int) -> None:
        pass

    def stop(self, check: bool = True) -> None:
        pass


def create_step_profiler(cfg: Any, exp_path: str, rank: int = 0, device: torch.device | None = None,
                         quiesce: Callable[[], ContextManager] | None = None):
    """A ``StepProfiler`` writing under ``<exp>/profile`` when
    ``finetune.profile.enabled``, else a ``NullProfiler``."""
    prof = cfg.select("finetune.profile") if hasattr(cfg, "select") else None
    if not prof or not prof.get("enabled", False):
        return NullProfiler()
    return StepProfiler(Path(exp_path) / "profile", start_step=int(prof.get("start_step", 2)),
                        num_steps=int(prof.get("num_steps", 3)), rank=rank, device=device, quiesce=quiesce)
