"""The KL reference policy on the port: ``InferenceEngine.score_tokens``
against the JAX engine's on the same fp32 weights, the preprocessor's
``ref_logprobs`` against the JAX preprocessor's on one group, and
``run_inline`` with ``kl_coef != 0``, whose reference engine must keep the
initial weights in storage of its own while the trainer steps."""

import copy
import json
import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pipelinerl_tpu.config import compose as j_compose
from pipelinerl_tpu.inference import engine as je
from pipelinerl_tpu.models import transformer as jt
from pipelinerl_tpu.preprocess import Preprocessor as JPreprocessor
from pipelinerl_tpu_torch import launch
from pipelinerl_tpu_torch.config import compose
from pipelinerl_tpu_torch.inference import engine as te
from pipelinerl_tpu_torch.models import transformer as tt
from pipelinerl_tpu_torch.preprocess import Preprocessor
from pipelinerl_tpu_torch.train.advantages import training_text_to_sample
from pipelinerl_tpu_torch.train.trainer import param_leaves
from pipelinerl_tpu_torch.types import TrainingText

torch.set_num_threads(1)
KW = dict(vocab_size=260, hidden_size=32, intermediate_size=64, num_layers=2, num_heads=2, num_kv_heads=2,
          attention_bias=True)
ENGINE = dict(max_slots=2, max_len=96, prefill_buckets=(16, 32, 64))


@pytest.fixture(scope="module")
def engines():
    """A JAX engine and a port engine on the same fp32 weights (seed 0)."""
    jcfg = jt.ModelConfig(dtype=jnp.float32, **KW)
    jparams = jt.init_params(jax.random.key(0), jcfg)
    tcfg = tt.ModelConfig(dtype=torch.float32, **KW)
    tparams = tt.params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    j_engine = je.InferenceEngine(jparams, jcfg, je.EngineConfig(cache_dtype=jnp.float32, **ENGINE), eos_token_id=0)
    t_engine = te.InferenceEngine(tparams, tcfg, te.EngineConfig(cache_dtype=torch.float32, **ENGINE),
                                  eos_token_id=0, device="cpu")
    yield j_engine, t_engine
    j_engine.stop()


@pytest.mark.parametrize("n,temperature", [(2, 1.0), (16, 1.0), (23, 0.7), (96, 1.0)])
def test_score_tokens_matches_jax(engines, n, temperature):
    """Rows that fill a bucket exactly, pad into the next one, and fill the
    last (``max_len``); logprobs within 1e-5."""
    j_engine, t_engine = engines
    ids = np.random.default_rng(n).integers(1, 256, n).tolist()
    got = t_engine.score_tokens(ids, temperature)
    want = j_engine.score_tokens(ids, temperature)
    assert len(got) == len(want) == n - 1
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert all(x <= 0 for x in got)
    with pytest.raises(ValueError):
        t_engine.score_tokens(ids + [1] * (97 - n))


def test_preprocessor_ref_logprobs_match_jax(engines, tmp_path):
    """One group of 8 samples (prompts masked): ``[0.0] + scored`` on the
    labels, 0 where a label is masked, as the JAX preprocessor aligns it."""
    j_engine, t_engine = engines
    rng = np.random.default_rng(3)
    samples = []
    for i in range(8):
        prompt = rng.integers(1, 256, int(rng.integers(5, 20))).tolist()
        completion = rng.integers(1, 256, int(rng.integers(1, 12))).tolist()
        text = TrainingText(input_ids=prompt + completion, labels=[-100] * len(prompt) + completion,
                            logprobs=[-1.0] * len(completion), reward=float(i % 3), finished=True,
                            finish_reason="stop", output_tokens=len(completion), group_id="g")
        samples.append(training_text_to_sample(text, model_version=0, rollout_index=i))
    msg = {"group_id": "g", "model_version": 0, "samples": samples}
    overrides = [f"output_dir={tmp_path}"]
    ours = Preprocessor(compose("bandit_cpu", overrides), str(tmp_path), None, eos_token_id=0,
                        ref_score_fn=t_engine.score_tokens).process_group(copy.deepcopy(msg))
    theirs = JPreprocessor(j_compose("conf", "bandit_cpu", overrides), str(tmp_path), None, eos_token_id=0,
                           ref_score_fn=j_engine.score_tokens).process_group(copy.deepcopy(msg))
    assert len(ours) == len(theirs) == 8
    for o, t in zip(ours, theirs):
        assert len(o["ref_logprobs"]) == len(o["input_ids"])
        np.testing.assert_allclose(o["ref_logprobs"], t["ref_logprobs"], rtol=0, atol=1e-5)
        masked = [r for r, label in zip(o["ref_logprobs"], o["labels"]) if label == -100]
        assert masked == [0.0] * len(masked)
        assert all(r < 0 for r, label in zip(o["ref_logprobs"], o["labels"]) if label != -100)
        assert o["advantages"] == pytest.approx(t["advantages"])


def test_validate_config_rejects_kl_without_a_reference_engine():
    cfg = compose("bandit_cpu", ["output_dir=/tmp/unused", "finetune.rl.kl_coef=0.05", "+world.ref_engine=false"])
    with pytest.raises(ValueError, match="zero reference policy"):
        launch.validate_config(cfg)
    launch.validate_config(compose("bandit_cpu", ["output_dir=/tmp/unused", "finetune.rl.kl_coef=0.05"]))


def test_run_inline_with_kl_keeps_the_reference_weights(tmp_path, monkeypatch):
    """``bandit_cpu`` with the ``ppo`` finetune group and ``kl_coef`` 0.05
    (the JAX package's tests/test_kl_inline_e2e.py): at least 2 optimizer
    steps, the reference engine at version 0 with the initial weights in
    storage the trainer never owned, a finite KL, and non-zero reference
    logprobs in the trainer's batches."""
    torch.set_num_threads(2)
    built, initial = [], {}
    build_model, build_engine = launch.build_model, launch.build_engine

    def spy_model(*args, **kw):
        out = build_model(*args, **kw)
        initial.update({name: p.detach().clone() for name, p in param_leaves(out[0])})
        built.append(out[0])
        return out

    def spy_engine(*args, **kw):
        built.append(build_engine(*args, **kw))
        return built[-1]

    monkeypatch.setattr(launch, "build_model", spy_model)
    monkeypatch.setattr(launch, "build_engine", spy_engine)
    cfg = compose("bandit_cpu", [f"output_dir={tmp_path}", "device=cpu", "finetune=ppo", "finetune.rl.kl_coef=0.05",
                                 "finetune.rl.final_kl_coef=0.05", "finetune.max_train_steps=4", "total_groups=24",
                                 "finetune.save_checkpoint_steps=0"])
    stats = launch.run_inline(cfg, device="cpu")
    assert stats["trainer"]["completed_steps"] >= 2, stats
    trained, policy, ref = built
    assert ref.version == 0 and policy.version > 0
    trained = dict(param_leaves(trained))
    for name, t in param_leaves(ref.params):
        assert torch.equal(t, initial[name]), name
        assert t.untyped_storage().data_ptr() != trained[name].untyped_storage().data_ptr(), name
    assert any(not torch.equal(trained[name].detach(), initial[name]) for name in initial)
    with open(tmp_path / "metrics" / "trainer_0.jsonl") as f:
        kls = [json.loads(line)["rl/kl"] for line in f]
    assert kls and all(math.isfinite(k) for k in kls)
    refs = []
    for part in (tmp_path / "streams" / "training_data").rglob("*.jsonl"):
        refs += [v for line in part.read_text().splitlines() for v in json.loads(line)["ref_logprobs"]]
    assert any(v != 0.0 for v in refs)
