"""The Llama 3 path on the CPU: the ``test`` preset from a
``LlamaForCausalLM`` directory (Llama-3.2-1B's published ``config.json``
cut to two layers and narrow widths, with its ``rope_scaling``, which both
packages leave unread; its vocabulary of 128,256 rows; random weights from
the JAX package's ``init_params``) and the committed Llama-3-style
tokenizer, through the port's ``launch`` and the JAX package's, greedy:
the same prompt and sampled ids. Both then train step 1 on the port's
recorded samples (``debug.mode=finetune``) at temperature 1 (the trainer
divides the logits by the rollout temperature, so a greedy run's own step
is NaN in both packages): the same loss. The port's loaded weights are
``params_from_numpy`` of the JAX ones, bit for bit. Each run is a child
process with a time limit; the port's run one torch thread."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pipelinerl_tpu.models import transformer as jt
from pipelinerl_tpu.train.checkpoints import export_hf as j_export_hf
from pipelinerl_tpu_torch.models import transformer as tt
from pipelinerl_tpu_torch.models.hf_loader import load_hf_model
from pipelinerl_tpu_torch.models.hf_tokenizer import HFTokenizer
from pipelinerl_tpu_torch.streams import SingleStreamSpec, StreamReader
from pipelinerl_tpu_torch.train.trainer import param_leaves
from tests.test_torch_hf_loader import LLAMA32_1B

REPO = Path(__file__).resolve().parent.parent
TOKENIZER = REPO / "pipelinerl_tpu_torch" / "fixtures" / "llama3_tokenizer"
# Llama-3.2-1B's widths cut for the CPU: D 2,048 → 64, F 8,192 → 128, 16
# layers → 2, H 32 → 8 and K 8 → 2 (G 4 as published), Dh 64 → 8; the
# vocabulary, rope_theta, rms_norm_eps and the tied head as published
NARROW = {"hidden_size": 64, "intermediate_size": 128, "num_hidden_layers": 2, "num_attention_heads": 8,
          "num_key_value_heads": 2, "head_dim": 8}
# the preset cut to a CPU run: one group of the preset's 4 attempts,
# greedy, 12 new tokens, one step of those 4 samples, fp32, an entropy
# bonus so the step's loss is not 0 (a greedy group's advantages are)
CUTS = ["total_groups=1", "finetune.samples_per_step=4", "finetune.max_train_steps=1", "llm.parameters.max_tokens=12",
        "llm.parameters.temperature=0.0", "engine.max_slots=4", "engine.max_len=544", "engine.prefill_buckets=[512]",
        "finetune.seq_length=544", "finetune.param_dtype=float32", "engine.cache_dtype=float32",
        "finetune.save_checkpoint_steps=0", "finetune.num_warmup_steps=0", "finetune.rl.entropy_bonus=0.001"]
TIMEOUT = 300


@pytest.fixture(scope="module")
def llama_dir(tmp_path_factory):
    config = {**LLAMA32_1B, **NARROW}
    cfg = jt.ModelConfig(vocab_size=config["vocab_size"], hidden_size=64, intermediate_size=128, num_layers=2,
                         num_heads=8, num_kv_heads=2, head_dim=8, rope_theta=config["rope_theta"],
                         rms_norm_eps=config["rms_norm_eps"], tie_word_embeddings=True, dtype=jnp.float32,
                         hf_architecture="LlamaForCausalLM")
    params = jt.init_params(jax.random.key(0), cfg)
    path = j_export_hf(tmp_path_factory.mktemp("llama"), params, cfg)
    (path / "config.json").write_text(json.dumps(config, indent=2))
    for name in ("tokenizer.json", "tokenizer_config.json", "special_tokens_map.json", "chat_template.jinja"):
        shutil.copyfile(TOKENIZER / name, path / name)
    return path, jax.tree.map(np.asarray, params)


def test_loaded_weights_are_params_from_numpy(llama_dir):
    path, params = llama_dir
    loaded, cfg = load_hf_model(path, dtype=torch.float32, device="cpu")
    expected = dict(param_leaves(tt.params_from_numpy(params, cfg, device="cpu")))
    assert sorted(expected) == sorted(name for name, _ in param_leaves(loaded))
    for name, t in param_leaves(loaded):
        assert torch.equal(t, expected[name]), name
    assert cfg.tie_word_embeddings and cfg.vocab_size == 128256 and cfg.num_heads // cfg.num_kv_heads == 4


def _start(cmd: list[str], env: dict) -> subprocess.Popen:
    return subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _finish(proc: subprocess.Popen, label: str) -> dict:
    try:
        out, err = proc.communicate(timeout=TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
        pytest.fail(f"the {label} run took more than {TIMEOUT} s: {err[-3000:]}")
    assert proc.returncode == 0, f"{label}: {err[-3000:]}"
    return json.loads(out.strip().splitlines()[-1])


def _samples(exp: Path) -> list[tuple]:
    groups = StreamReader(SingleStreamSpec(str(exp), "actor")).read_available()
    return sorted((tuple(s["input_ids"]), tuple(s["labels"])) for g in groups for s in g["samples"])


def _step_loss(exp: Path) -> float:
    with open(exp / "metrics" / "trainer_0.jsonl") as f:
        return [json.loads(line) for line in f][0]["loss"]


def _both(tmp_path: Path, name: str, args: list[str]) -> tuple[dict, dict]:
    """The port's and the JAX package's ``launch`` on ``args``, side by
    side, into ``<name>_port`` and ``<name>_jax``."""
    env = {**os.environ, "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}
    jax_env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    jax_env.pop("XLA_FLAGS", None)
    port = _start([sys.executable, "-m", "pipelinerl_tpu_torch.launch", *args,
                   f"output_dir={tmp_path / f'{name}_port'}", "device=cpu"], env)
    jax_run = _start([sys.executable, "-c", "from pipelinerl_tpu.launch import main; main()", "--config-dir=conf",
                      *args, f"output_dir={tmp_path / f'{name}_jax'}"], jax_env)
    return _finish(port, f"port {name}"), _finish(jax_run, f"JAX {name}")


def test_test_preset_from_a_llama_directory_equals_jax(llama_dir, tmp_path):
    path, _ = llama_dir
    common = ["--config-name=test", f"model_path={path}", *CUTS]
    stats, j_stats = _both(tmp_path, "greedy", common)
    assert stats["trainer"]["completed_steps"] == j_stats["trainer"]["completed_steps"] == 1
    ours, theirs = _samples(tmp_path / "greedy_port"), _samples(tmp_path / "greedy_jax")
    assert len(ours) == 4 and ours == theirs
    prompt = [i for i, label in zip(*ours[0]) if label == -100]
    completion = [i for i, label in zip(*ours[0]) if label != -100]
    # the chat template's <|begin_of_text|> and headers at their published
    # ids; the sampled ids stay under valid_vocab (the tokenizer's entries)
    assert prompt[:2] == [128000, 128006] and len(completion) == 12 and max(completion) < len(HFTokenizer(TOKENIZER))
    assert np.isnan(_step_loss(tmp_path / "greedy_port")) and np.isnan(_step_loss(tmp_path / "greedy_jax"))
    replay = [*common, "llm.parameters.temperature=1.0", "+debug.mode=finetune",
              f"+debug.streams_from={tmp_path / 'greedy_port'}"]
    stats, j_stats = _both(tmp_path, "replay", replay)
    assert stats["trainer"]["samples"] == j_stats["trainer"]["samples"] == 4
    loss, j_loss = _step_loss(tmp_path / "replay_port"), _step_loss(tmp_path / "replay_jax")
    assert np.isfinite(loss) and loss != 0 and np.isclose(loss, j_loss, rtol=1e-4, atol=1e-8), (loss, j_loss)
