"""The port's memory debugger and step profiler (``utils/memory_debug.py``)
against the JAX package's: the four cases of JAX's
``tests/test_memory_debug.py`` on the port, the same record keys for the
same calls, and ``bandit_cpu`` inline with both switches on in both
packages: the same ``(phase, step)`` records in ``memory_debug_0.jsonl``,
and a port trace under ``<exp>/profile`` with CPU events."""

import json
from pathlib import Path

import pytest
import torch

from pipelinerl_tpu import launch as j_launch
from pipelinerl_tpu.config import Config as JConfig
from pipelinerl_tpu.config import compose as j_compose
from pipelinerl_tpu.utils import memory_debug as j_md
from pipelinerl_tpu_torch.config import Config, compose
from pipelinerl_tpu_torch.launch import run_inline
from pipelinerl_tpu_torch.utils.memory_debug import (
    MemoryDebugger,
    NullDebugger,
    NullProfiler,
    StepProfiler,
    create_memory_debugger,
    create_step_profiler,
)

torch.set_num_threads(1)


def records(path: Path) -> list[dict]:
    return [json.loads(line) for line in path.open()]


def test_snapshots_written_with_expected_fields(tmp_path):
    dbg = MemoryDebugger(tmp_path, rank=3, every_n=2)
    for step in range(4):
        dbg.snapshot("before_train_pass", step=step, queue_depth=step)
    dbg.snapshot("after_save", step=99)
    dbg.close()
    lines = records(tmp_path / "memory_debug_3.jsonl")
    # every_n=2 keeps snapshots 0 and 2 of the phase, plus the save phase
    assert [line["step"] for line in lines] == [0, 2, 99]
    first = lines[0]
    assert first["phase"] == "before_train_pass"
    assert first["queue_depth"] == 0
    assert "vmrss" in first  # host RSS from /proc
    assert "live_array_bytes" in first


def test_gating(tmp_path):
    assert isinstance(create_memory_debugger(Config({}), str(tmp_path)), NullDebugger)
    cfg = Config({"finetune": {"memory_debug": {"enabled": True}}})
    dbg = create_memory_debugger(cfg, str(tmp_path), rank=0)
    assert isinstance(dbg, MemoryDebugger)
    dbg.close()
    assert isinstance(create_step_profiler(Config({}), str(tmp_path)), NullProfiler)


def test_step_profiler_trace(tmp_path):
    prof = StepProfiler(tmp_path / "prof", start_step=2, num_steps=2)
    x = torch.ones(8, 8)
    for step in range(6):
        prof.on_step(step)
        x = x * 2 + 1
    prof.stop()
    assert not prof.active
    # a TensorBoard-readable trace: one JSON file named for the rank
    produced = list(Path(tmp_path / "prof").rglob("*"))
    assert produced == [prof.trace_path] and prof.trace_path.name.startswith("rank0.")
    assert json.loads(prof.trace_path.read_text())["traceEvents"]


def test_step_profiler_checks_raise_only_when_asked(tmp_path, monkeypatch, caplog):
    # a handler that writes nothing: stop() raises, stop(check=False) (the
    # trainer's exit on an error, which the check must not mask) logs it
    monkeypatch.setattr(torch.profiler, "tensorboard_trace_handler", lambda *a, **k: lambda prof: None)
    for check in (True, False):
        prof = StepProfiler(tmp_path / f"prof_{check}", start_step=0, num_steps=1)
        prof.on_step(0)
        torch.ones(4) * 2
        if check:
            with pytest.raises(RuntimeError, match="wrote no trace"):
                prof.stop()
        else:
            prof.stop(check=False)
            assert "wrote no trace" in caplog.text
        assert not prof.active and prof.trace_path is None


def test_trainer_config_plumbing(tmp_path):
    cfg = Config({"finetune": {"profile": {"enabled": True, "start_step": 1, "num_steps": 1}}})
    prof = create_step_profiler(cfg, str(tmp_path))
    assert isinstance(prof, StepProfiler)
    assert prof.start_step == 1 and prof.stop_step == 2


def test_record_keys_equal_jax(tmp_path):
    """The same calls on the CPU give records with the same keys in the same
    order (host readings, the tensor or array census, the extras)."""
    held = torch.ones(1000)  # in the port's census
    out = {}
    for name, cls in (("port", MemoryDebugger), ("jax", j_md.MemoryDebugger)):
        dbg = cls(tmp_path / name, rank=1, every_n=1)
        dbg.snapshot("after_train_pass", step=3, queue_depth=2, note="x")
        dbg.snapshot("after_save", step=4)
        dbg.close()
        out[name] = records(tmp_path / name / "memory_debug_1.jsonl")
    assert [list(r) for r in out["port"]] == [list(r) for r in out["jax"]]
    assert [(r["phase"], r["step"]) for r in out["port"]] == [("after_train_pass", 3), ("after_save", 4)]
    assert out["port"][0]["live_arrays"] >= 1 and out["port"][0]["live_array_bytes"] >= held.numel() * 4


def test_the_gates_read_alike_in_both_packages(tmp_path):
    for key, cfg in (("memory_debug", {"enabled": True, "every_n": 3}),
                     ("profile", {"enabled": True, "start_step": 4, "num_steps": 2})):
        port = (create_memory_debugger if key == "memory_debug" else create_step_profiler)(
            Config({"finetune": {key: cfg}}), str(tmp_path / "port"))
        jax = (j_md.create_memory_debugger if key == "memory_debug" else j_md.create_step_profiler)(
            JConfig({"finetune": {key: cfg}}), str(tmp_path / "jax"))
        if key == "memory_debug":
            assert port.every_n == jax.every_n == 3
            assert port.path.relative_to(tmp_path / "port") == jax.path.relative_to(tmp_path / "jax")
            port.close()
            jax.close()
        else:
            assert (port.start_step, port.stop_step) == (jax.start_step, jax.stop_step) == (4, 6)
            assert Path(port.out_dir).relative_to(tmp_path / "port") == Path(jax.out_dir).relative_to(tmp_path / "jax")


SWITCHES = ["finetune.save_checkpoint_steps=2", "finetune.max_train_steps=3", "actor.publish_stats_every_n_groups=2",
            "+finetune.memory_debug.enabled=true", "+finetune.profile.enabled=true",
            "+finetune.profile.start_step=1", "+finetune.profile.num_steps=1"]


def phases(exp: Path) -> list[tuple[str, int]]:
    return [(r["phase"], r["step"]) for r in records(exp / "metrics" / "memory_debug_0.jsonl")]


def test_bandit_cpu_inline_writes_jax_records_and_a_trace(tmp_path):
    """The port's inline ``bandit_cpu`` run with both switches on writes the
    passes, optimizer steps, pushes and the step-2 save, and a trace of
    step 2 with CPU op events. How many passes a step takes follows how the
    preprocessor packed what had arrived, in either package; so both
    packages then replay the run's ``training_data`` (``debug.mode:
    finetune``) with the switches on and write the same (phase, step)
    records."""
    recorded = tmp_path / "recorded"
    stats = run_inline(compose("bandit_cpu", [f"output_dir={recorded}", "device=cpu", *SWITCHES]), device="cpu")
    assert stats["trainer"]["completed_steps"] == 3
    seen = phases(recorded)
    assert ("after_save", 2) in seen and seen[-2:] == [("after_optimizer_step", 3), ("after_weight_push", 3)]
    traces = list((recorded / "profile").glob("rank0.*.pt.trace.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)
    ov = [*SWITCHES, "+debug.mode=finetune", f"+debug.streams_from={recorded}"]
    port, jax = tmp_path / "port", tmp_path / "jax"
    run_inline(compose("bandit_cpu", [f"output_dir={port}", "device=cpu", *ov]), device="cpu")
    j_launch.run_inline(j_compose("conf", "bandit_cpu", [f"output_dir={jax}", *ov]))
    assert phases(port) == phases(jax) == seen
    assert list((port / "profile").glob("rank0.*.pt.trace.json"))
    assert any(p.is_file() for p in (jax / "profile").rglob("*"))


def test_tensor_census_beside_a_thread_building_tuples():
    """The CPU census walks ``gc.get_objects()``, which also returns a tuple
    another thread is still growing (``tuple(generator)``, its generator
    releasing the GIL in a torch op); holding it past a GIL hand-off made
    that thread's resize raise ``SystemError`` and killed an inline run's
    engine thread mid-prefill, so the run hung. Two seconds of censuses
    beside such a thread: none of its tuples breaks, and the census sees
    the tensors."""
    import threading
    import time

    from pipelinerl_tpu_torch.utils.memory_debug import _tensor_census

    rows = torch.randn(8, 64, 64)
    errors: list[str] = []
    stop = threading.Event()

    def build() -> None:
        while not stop.is_set():
            try:
                tuple(t.matmul(t) for t in rows.unbind(0))
            except SystemError as e:
                errors.append(repr(e))
                return

    thread = threading.Thread(target=build, daemon=True)
    thread.start()
    censuses, t0 = [], time.monotonic()
    try:
        while time.monotonic() - t0 < 2.0 and not errors:
            censuses.append(_tensor_census())
    finally:
        stop.set()
        thread.join(timeout=10)
    assert not errors, errors
    assert censuses and all(n >= 1 and nbytes >= rows.nbytes for n, nbytes in censuses)
