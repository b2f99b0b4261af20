"""The ``tir``, ``coding`` and ``miniwob`` presets, and ``deep_research``
through the ``base`` preset, through the port's ``launch.main`` on the CPU
from the JAX package's fixture HF directory: one train step each on the
hermetic sets, every reward one the domain can give, every rollout within
its turn budget. ``chip_smoke.py`` phases 21-23 run the same at the
presets' own widths on the card."""

import math

import pytest
import torch

from chip_smoke import tir_rewards
from pipelinerl_tpu.models.hf_fixture import build_hf_checkpoint
from pipelinerl_tpu_torch import launch
from pipelinerl_tpu_torch.config import compose
from pipelinerl_tpu_torch.domains.math.rollouts import RewardTable, length_penalty
from pipelinerl_tpu_torch.models.hf_tokenizer import HFTokenizer
from pipelinerl_tpu_torch.streams import SingleStreamSpec, StreamReader

torch.set_num_threads(1)
# the presets cut to a CPU run: 4 attempts, one step of 8 samples, fp32
# weights and cache, small engine and trainer rows
CUTS = ["device=cpu", "attempts=4", "finetune.samples_per_step=8", "finetune.max_train_steps=1",
        "engine.max_slots=8", "finetune.param_dtype=float32", "engine.cache_dtype=float32",
        "finetune.save_checkpoint_steps=0", "finetune.num_warmup_steps=0", "total_groups=2"]


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    return build_hf_checkpoint(tmp_path_factory.mktemp("hf_fixture"), dtype="float32")


def samples(out):
    return [s for g in StreamReader(SingleStreamSpec(str(out), "actor")).read_available() for s in g["samples"]]


def snapshots(out, stats):
    return list(StreamReader(SingleStreamSpec(str(out), "stats")).read_available()) + [stats["actor"]]


def run(name, hf_dir, out, *overrides):
    stats = launch.main([f"--config-name={name}", f"model_path={hf_dir}", f"output_dir={out}", *CUTS, *overrides])
    assert stats["trainer"]["completed_steps"] == 1 and math.isfinite(stats["trainer"]["train_loss"])
    return stats


def n_output(sample):
    return sum(1 for label in sample["labels"] if label != -100)


def test_tir_preset_runs_on_one_device(hf_dir, tmp_path, monkeypatch):
    """``parallel.cp=1`` (as shipped, ``cp: 8`` is a trainer world of eight
    ranks, one per device: its DRY_RUN lists them): each rollout's reward is
    the one its texts give for some answer status (the math table's entry,
    ``compute_shaping`` of its python calls and mean turn length, the
    overlong term of that mean), as ``chip_smoke.py`` phase 21 holds it; no
    rollout passes ``max_turns``."""
    out = tmp_path / "tir"
    with monkeypatch.context() as m:
        m.setenv("DRY_RUN", "1")
        with pytest.raises(SystemExit) as done:
            launch.main(["--config-name=tir", f"model_path={hf_dir}", f"output_dir={tmp_path}/cp", *CUTS,
                         "llm.parameters.max_tokens=16", "engine.max_len=512", "engine.prefill_buckets=[256]",
                         "finetune.seq_length=512", "train_dataset_names=[synthetic_arithmetic]"])
    assert done.value.code == 0 and len(list((tmp_path / "cp" / "trainer").glob("start_trainer_*.sh"))) == 8
    overrides = ["parallel.cp=1", "llm.parameters.max_tokens=16", "engine.max_len=512",
                 "engine.prefill_buckets=[256]", "finetune.seq_length=512", "rewards.buffer_tokens=8",
                 "train_dataset_names=[synthetic_arithmetic]"]
    stats = run("tir", hf_dir, out, *overrides)
    cfg = compose("tir", ["output_dir=/tmp/unused", "model_path=/unused", *overrides])
    table, tok = RewardTable.from_config(cfg), HFTokenizer(hf_dir)
    rollouts = {}
    for s in samples(out):
        rollouts.setdefault((s["group_id"], s["rollout_index"]), []).append(s)
    for texts in rollouts.values():
        assert len(texts) <= 6
        assert any(all(abs(t["reward"] - r) < 1e-9 for t in texts) for r in tir_rewards(cfg, table, tok, texts)), \
            [t["reward"] for t in texts]
    assert max(snap.get("num_steps_max", 0) for snap in snapshots(out, stats)) <= 6


def test_coding_preset_runs_without_a_sandbox(hf_dir, tmp_path):
    """No ``sandbox_url``: no code runs, so every reward is the table's
    unparsable or no-answer entry plus the overlong penalty."""
    out = tmp_path / "coding"
    run("coding", hf_dir, out, "llm.parameters.max_tokens=16", "engine.max_len=512", "engine.prefill_buckets=[256]",
        "finetune.seq_length=512", "rewards.buffer_tokens=8", "train_dataset_names=[synthetic_coding]")
    table = RewardTable.from_config(compose("coding", ["output_dir=/tmp/unused", "model_path=/unused"]))
    for s in samples(out):
        suffix = "finished" if s["finished"] else "not_finished"
        base = {getattr(table, f"{status}_{suffix}") for status in ("unparsable", "no_answer")}
        assert any(abs(s["reward"] - b - length_penalty(16, n_output(s), 8)) < 1e-9 for b in base), s["reward"]


def test_miniwob_preset_runs_the_simulated_env_in_process(hf_dir, tmp_path):
    """The simulated tasks in process: each reward is what
    ``compute_reward`` gives under ``nico`` (-1, or the raw reward times
    0.99 per step error), and no episode passes ``agent_max_loops``."""
    out = tmp_path / "miniwob"
    stats = run("miniwob", hf_dir, out, "llm.parameters.max_tokens=8", "actor.agent_max_loops=2", "total_groups=1",
                "engine.max_len=1024", "engine.prefill_buckets=[512]", "finetune.seq_length=1024")
    rewards = {s["reward"] for s in samples(out)}
    assert rewards and all(r == -1.0 or any(abs(r - 0.99**k) < 1e-12 for k in range(7)) for r in rewards), rewards
    assert max(snap.get("n_llm_calls_max", 0) for snap in snapshots(out, stats)) <= 2


def test_deep_research_runs_through_the_base_preset(hf_dir, tmp_path):
    """The ``base`` preset with the research policy and loader (there is no
    preset): rewards from the domain's set."""
    out = tmp_path / "deep_research"
    run("base", hf_dir, out, "rollout_policy=pipelinerl_tpu_torch.domains.deep_research.generate_research_rollout",
        "dataset_loader=pipelinerl_tpu_torch.domains.deep_research.load_problems", "actor.max_loops=3",
        "llm.parameters.max_tokens=8", "engine.max_len=1024", "engine.prefill_buckets=[512]",
        "finetune.seq_length=1024")
    allowed = [-1.0] + [base - 0.05 * k for base in (1.0, -0.5) for k in range(3)]
    for s in samples(out):
        assert s["domain"] == "deep_research"
        assert any(abs(s["reward"] - r) < 1e-9 for r in allowed), s["reward"]
