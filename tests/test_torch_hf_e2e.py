"""The port's inline RL loop from a genuine HF checkpoint directory, on the
CPU: the JAX package's ``build_hf_checkpoint`` writes it (Qwen2 architecture,
byte-level BPE tokenizer with merges, ChatML template, a model vocabulary
padded past the tokenizer), as ``tests/test_hf_fixture_e2e.py`` runs it
through the JAX package. ``launch.main --config-name=guessing`` trains a
step and checkpoints, a second run resumes and trains one more, and the
export loads back. Also the ``base`` preset, whose default
``save_checkpoint_steps`` is 100, gets past ``TrainerLoop``'s
construction."""

import json

import pytest
import torch

from pipelinerl_tpu.models.hf_fixture import build_hf_checkpoint
from pipelinerl_tpu_torch import launch
from pipelinerl_tpu_torch.config import compose
from pipelinerl_tpu_torch.models.hf_loader import load_hf_model
from pipelinerl_tpu_torch.streams import SingleStreamSpec, StreamReader
from pipelinerl_tpu_torch.train.trainer import TrainerLoop, param_leaves

torch.set_num_threads(1)
# the guessing preset cut to a CPU run: 4 attempts, 16 new tokens, two
# groups per step of 8 samples, fp32 weights and cache, no warmup
CUTS = ["device=cpu", "attempts=4", "total_groups=4", "finetune.samples_per_step=8", "llm.parameters.max_tokens=16",
        "engine.max_slots=8", "engine.max_len=256", "engine.prefill_buckets=[128,256]", "finetune.seq_length=256",
        "finetune.param_dtype=float32", "engine.cache_dtype=float32", "finetune.save_checkpoint_steps=1",
        "finetune.num_warmup_steps=0", "finetune.learning_rate=1e-3"]


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    return build_hf_checkpoint(tmp_path_factory.mktemp("hf_fixture"), dtype="float32")


def test_guessing_runs_from_hf_dir_saves_resumes_and_exports(hf_dir, tmp_path):
    out = tmp_path / "run"
    common = ["--config-name=guessing", f"model_path={hf_dir}", f"output_dir={out}", *CUTS]
    first = launch.main([*common, "finetune.max_train_steps=1"])
    assert first["trainer"]["completed_steps"] == 1 and first["trainer"]["last_broadcasted_version"] == 8
    assert (out / "finetune" / "training_state" / "state.pt").exists()
    assert (out / "finetune" / "current" / "model.safetensors").exists()
    samples = [s for g in StreamReader(SingleStreamSpec(str(out), "actor")).read_available() for s in g["samples"]]
    completions = [i for s in samples for i, label in zip(s["input_ids"], s["labels"]) if label != -100]
    assert completions and max(completions) < 540  # valid_vocab: the padded rows are never sampled
    assert first["engine"]["generated_tokens"] > 0

    second = launch.main([*common, "finetune.max_train_steps=2"])
    assert second["trainer"]["completed_steps"] == 2  # resumed at 1
    assert second["trainer"]["samples"] == 16 and second["trainer"]["last_broadcasted_version"] == 16
    saved = json.loads((out / "finetune" / "training_state" / "metrics.json").read_text())
    assert saved["completed_steps"] == 2

    exported, cfg = load_hf_model(out / "finetune" / "current", dtype=torch.float32, device="cpu")
    original, _ = load_hf_model(hf_dir, dtype=torch.float32, device="cpu")
    assert cfg.hf_architecture == "Qwen2ForCausalLM" and cfg.vocab_size == 768
    state = torch.load(out / "finetune" / "training_state" / "state.pt", weights_only=True)
    for name, t in param_leaves(exported):
        assert torch.equal(t, state["params"][name]), name  # the export holds the trainer's last weights
    # the rewards are all equal, so only the decay moves the weights
    assert any(not torch.equal(a, b) for (_, a), (_, b) in zip(param_leaves(exported), param_leaves(original)))

    third = launch.main([*common, "finetune.max_train_steps=1", "force_restart=true"])
    assert third["trainer"]["completed_steps"] == 1 and third["trainer"]["samples"] == 8


def test_base_preset_constructs_its_trainer(tmp_path):
    cfg = compose("base", [f"output_dir={tmp_path}", "model_path=toy"])
    assert cfg.finetune.save_checkpoint_steps == 100
    params, model_cfg, _ = launch.build_model(cfg, device="cpu")
    trainer = TrainerLoop(cfg, params, model_cfg, str(tmp_path))
    assert trainer.save_checkpoint_steps == 100 and trainer.checkpoint_dir == tmp_path / "finetune"
