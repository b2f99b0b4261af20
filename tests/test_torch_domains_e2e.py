"""The ``math`` and ``multi_domain`` presets through the port's
``launch.main`` on the CPU, from the JAX package's fixture HF directory
(Qwen2 architecture, byte-level BPE tokenizer, a vocabulary padded past the
tokenizer): one train step each on the hermetic sets, with the
difficulty-aware penalty on in the math run and the preset's domain mix in
the multi-domain run."""

import json

import pytest
import torch

from pipelinerl_tpu.models.hf_fixture import build_hf_checkpoint
from pipelinerl_tpu_torch import launch
from pipelinerl_tpu_torch.domains.math.rollouts import RewardTable
from pipelinerl_tpu_torch.streams import SingleStreamSpec, StreamReader

torch.set_num_threads(1)
# the presets cut to a CPU run: 4 attempts, 24 new tokens, one step of 8
# samples, fp32 weights and cache, a 384-row engine and trainer row
CUTS = ["device=cpu", "attempts=4", "finetune.samples_per_step=8", "finetune.max_train_steps=1",
        "llm.parameters.max_tokens=24", "engine.max_slots=8", "engine.max_len=384", "engine.prefill_buckets=[256]",
        "finetune.seq_length=384", "finetune.param_dtype=float32", "engine.cache_dtype=float32",
        "finetune.save_checkpoint_steps=0", "finetune.num_warmup_steps=0"]


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    return build_hf_checkpoint(tmp_path_factory.mktemp("hf_fixture"), dtype="float32")


def samples(out):
    return [s for g in StreamReader(SingleStreamSpec(str(out), "actor")).read_available() for s in g["samples"]]


def test_math_preset_runs_with_the_difficulty_aware_penalty(hf_dir, tmp_path):
    out = tmp_path / "math"
    stats = launch.main(["--config-name=math", f"model_path={hf_dir}", f"output_dir={out}", *CUTS,
                         "total_groups=2", "train_dataset_names=[synthetic_arithmetic,countdown]",
                         "rewards.buffer_tokens=8", "actor.difficulty_aware_penalty.enabled=true"])
    assert stats["trainer"]["completed_steps"] == 1 and stats["actor"]["groups_completed"] == 2
    rows = samples(out)
    table = RewardTable()
    for s in rows:
        n_out = sum(1 for label in s["labels"] if label != -100)
        base = [v for k, v in vars(table).items() if k != "buffer_tokens"
                and k.endswith("_not_finished") != s["finished"]]
        # the table's value plus a penalty in [-1, 0]; a rollout cut at
        # max_tokens carries the full penalty
        assert any(-1.0 <= s["reward"] - b <= 0.0 for b in base), s["reward"]
        if n_out == 24 and not s["finished"]:
            assert any(s["reward"] == b - 1.0 for b in base)
        assert max(i for i, label in zip(s["input_ids"], s["labels"]) if label != -100) < 540
    prompt = [i for i, label in zip(rows[0]["input_ids"], rows[0]["labels"]) if label == -100]
    assert len(prompt) <= 256 and stats["engine"]["generated_tokens"] > 0


def test_multi_domain_preset_draws_and_dispatches_every_domain(hf_dir, tmp_path):
    """Sixteen groups drawn under the preset's mix (the draws are seeded and
    equal JAX's; the 5th and 16th are counting groups). The run ends once
    the trainer's step is done and cancels the groups still in flight, so
    the step takes all 16 groups' 64 samples: the ``actor`` stream then
    holds every group drawn, whatever order they finish in."""
    out = tmp_path / "multi"
    stats = launch.main(["--config-name=multi_domain", f"model_path={hf_dir}", f"output_dir={out}", *CUTS,
                         "finetune.samples_per_step=64", "total_groups=16", "actor.max_parallel_groups=16",
                         "actor.publish_stats_every_n_groups=2",
                         "train_dataset_names=[math::synthetic_arithmetic,math::countdown,guessing::train,"
                         "counting::train]"])
    assert stats["trainer"]["completed_steps"] == 1 and stats["trainer"]["samples"] == 64
    assert stats["actor"]["groups_completed"] == 16 and len(samples(out)) == 64
    domains = {s["domain"] for s in samples(out)}
    snapshots = list(StreamReader(SingleStreamSpec(str(out), "stats")).read_available()) + [stats["actor"]]
    reported = {k.split("/")[1] for snap in snapshots for k in snap if k.startswith("domain/")}
    assert domains == reported == {"math", "guessing", "counting"}, (domains, reported)
    saved = json.loads((out / "conf" / "exp_config.json").read_text())
    assert saved["domain_mix"] == {"math": 0.6, "guessing": 0.2, "counting": 0.2}
