"""The step profiler starts and stops its trace while no other thread of the
process launches on the device: ``StepProfiler`` under its ``quiesce``
context, and an inline run's engine (``InferenceEngine.quiesced``) holding
its steps while that context is held. On a card CUPTI's trace teardown
crashed the process while the engine thread was mid-decode."""

import contextlib
import threading
import time

import torch

from pipelinerl_tpu_torch.inference import engine as te
from pipelinerl_tpu_torch.launch import run_inline
from pipelinerl_tpu_torch.config import compose
from pipelinerl_tpu_torch.models import transformer as tt
from pipelinerl_tpu_torch.train import trainer as trainer_mod
from pipelinerl_tpu_torch.utils.memory_debug import StepProfiler, create_step_profiler

torch.set_num_threads(1)


def test_the_trace_starts_and_stops_under_quiesce(tmp_path, monkeypatch):
    held = []

    @contextlib.contextmanager
    def quiesce():
        held.append(True)
        try:
            yield
        finally:
            held.pop()

    seen = []
    start, stop = torch.profiler.profile.start, torch.profiler.profile.stop
    monkeypatch.setattr(torch.profiler.profile, "start", lambda self: (seen.append(("start", bool(held))), start(self)))
    monkeypatch.setattr(torch.profiler.profile, "stop", lambda self: (seen.append(("stop", bool(held))), stop(self)))
    prof = StepProfiler(tmp_path / "prof", start_step=1, num_steps=1, quiesce=quiesce)
    prof.on_step(0)
    torch.ones(4) @ torch.ones(4)
    prof.on_step(1)
    torch.ones(4) @ torch.ones(4)
    prof.on_step(2)
    assert seen == [("start", True), ("stop", True)] and not held
    assert prof.trace_path is not None and prof.trace_path.exists()


def test_create_step_profiler_passes_quiesce_on(tmp_path):
    cfg = compose("bandit_cpu", [f"output_dir={tmp_path}", "+finetune.profile.enabled=true"])
    lock = threading.Lock()
    prof = create_step_profiler(cfg, str(tmp_path), quiesce=lambda: lock)
    assert isinstance(prof, StepProfiler) and prof.quiesce() is lock
    assert create_step_profiler(cfg, str(tmp_path)).quiesce is contextlib.nullcontext


def test_the_engine_launches_nothing_while_quiesced():
    """A started engine holds a submitted request while ``quiesced`` is held
    and serves it once the context ends."""
    cfg = tt.ModelConfig(vocab_size=32, hidden_size=32, intermediate_size=64, num_layers=2, num_heads=2,
                         num_kv_heads=2, dtype=torch.float32)
    params = tt.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    engine = te.InferenceEngine(params, cfg, te.EngineConfig(max_slots=2, max_len=64, prefill_buckets=(8, 16),
                                                             cache_dtype=torch.float32), eos_token_id=0, device="cpu")
    engine.start()
    try:
        with engine.quiesced():
            fut = engine.submit(te.GenRequest([1, 2, 3], te.SamplingParams(temperature=0.0, max_tokens=4)))
            time.sleep(0.3)
            assert not fut.done()
        assert len(fut.result(timeout=60).token_ids) >= 1
    finally:
        engine.stop()


def test_an_inline_run_gives_the_trainer_its_engine(tmp_path, monkeypatch):
    """``run_inline`` builds the trainer with the engine's ``quiesced``, and
    the profiled run still ends (no lock is held across the trace)."""
    given = []
    init = trainer_mod.TrainerLoop.__init__

    def recording_init(self, *args, **kwargs):
        given.append(kwargs.get("device_quiesce"))
        init(self, *args, **kwargs)

    monkeypatch.setattr(trainer_mod.TrainerLoop, "__init__", recording_init)
    stats = run_inline(compose("bandit_cpu", [f"output_dir={tmp_path}", "device=cpu", "finetune.max_train_steps=2",
                                              "+finetune.profile.enabled=true", "+finetune.profile.start_step=1",
                                              "+finetune.profile.num_steps=1"]), device="cpu")
    assert stats["trainer"]["completed_steps"] == 2
    assert len(given) == 1 and getattr(given[0], "__name__", "") == "quiesced"
    assert list((tmp_path / "profile").glob("rank0.*.pt.trace.json"))
