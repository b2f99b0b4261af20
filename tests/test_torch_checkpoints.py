"""Checkpoints of the port (``train/checkpoints.py`` and the trainer's
``save_checkpoint``/``try_resume``): a resumed run equals an uninterrupted
one bit for bit at fp32; an absent state or a left-over ``~tmp`` directory
is harmless; ``export_hf`` writes the bytes the JAX package's ``export_hf``
writes for the same weights, and the JAX loader reads the port's export."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pipelinerl_tpu.models import hf_loader as jl
from pipelinerl_tpu.models import transformer as jt
from pipelinerl_tpu.train.advantages import populate_rl_data, prepare_rl_fields
from pipelinerl_tpu.train.checkpoints import export_hf as j_export_hf
from pipelinerl_tpu.train.packing import pack_samples
from pipelinerl_tpu_torch.config import compose
from pipelinerl_tpu_torch.models import transformer as tt
from pipelinerl_tpu_torch.models.hf_loader import load_hf_model
from pipelinerl_tpu_torch.train import checkpoints as ck
from pipelinerl_tpu_torch.train.trainer import TrainerLoop, param_leaves
from pipelinerl_tpu_torch.types import TrainerBatch

torch.set_num_threads(1)
EOS = 257
MODEL = tt.ModelConfig(vocab_size=260, hidden_size=32, intermediate_size=64, num_layers=2, num_heads=2,
                       num_kv_heads=2, dtype=torch.float32)


def batch(seed: int, L: int = 64) -> TrainerBatch:
    rng = np.random.default_rng(seed)
    samples = []
    for i in range(4):
        ids = [256, *rng.integers(97, 123, 8).tolist(), 257, *rng.integers(97, 123, 3).tolist()]
        samples.append(prepare_rl_fields({
            "input_ids": ids, "labels": [-100] * 10 + ids[10:], "reward": float(rng.random()),
            "logprobs": (-rng.random(3) - 0.5).tolist(), "group_id": "g", "rollout_index": i,
            "step_index": 0, "model_version": seed, "finished": True, "finish_reason": "stop",
        }))
    populate_rl_data(samples, EOS)
    return TrainerBatch.from_msg(pack_samples(samples, L, EOS).to_msg())


# wide enough that Adafactor factors the embedding and the stacked MLP
WIDE = dataclasses.replace(MODEL, hidden_size=128, intermediate_size=160)


def loop(exp_path, *overrides, value_head=False) -> TrainerLoop:
    cfg = compose("bandit_cpu", ["output_dir=/unused", "finetune.num_warmup_steps=2", *overrides])
    model = WIDE if "finetune.optim=adafactor" in overrides else MODEL
    params = tt.init_params(torch.Generator().manual_seed(0), model, "cpu")
    if value_head:
        params["value_head"] = tt.init_value_head(torch.Generator().manual_seed(1), model, "cpu")
    return TrainerLoop(cfg, params, model, str(exp_path))


def step(trainer: TrainerLoop, seed: int) -> None:
    trainer.train_pass(batch(seed))
    trainer.optimizer_step()


def optimizer_tensors(trainer: TrainerLoop) -> list[torch.Tensor]:
    return [t for s in trainer.optimizer.state_dict()["state"].values() for t in s.values()]


@pytest.mark.parametrize("overrides", [
    (), ("+finetune.lora.enabled=true", "+finetune.lora.r=4", '+finetune.lora.target_modules=["wq","wv","wup"]'),
    ("finetune.optim=lion",), ("finetune.optim=adafactor",),
], ids=["full", "lora", "lion", "adafactor"])
def test_resumed_run_equals_uninterrupted_bit_for_bit(tmp_path, overrides):
    """Two steps, save, a new TrainerLoop that resumes, one more step:
    params, the optimizer's state and step counts (Adam's moments, Lion's
    mu, Adafactor's factored and full second moments), the scheduler's lr
    and the metrics equal three uninterrupted steps exactly (warmup 2, so
    the lr schedule crosses its corner across the save)."""
    straight = loop(tmp_path / "straight", *overrides)
    for seed in (1, 2, 3):
        step(straight, seed)

    first = loop(tmp_path / "resumed", *overrides)
    step(first, 1)
    step(first, 2)
    first.save_checkpoint()
    second = loop(tmp_path / "resumed", *overrides)
    assert second.metrics.completed_steps == 0
    assert second.try_resume()
    assert (second.metrics.completed_steps, second.metrics.samples) == (2, 8)
    for (name, p), (_, q) in zip(param_leaves(second.params), param_leaves(first.params)):
        assert torch.equal(p, q), name
    step(second, 3)

    assert second.metrics.completed_steps == straight.metrics.completed_steps == 3
    assert second.metrics.lr == straight.metrics.lr and second.metrics.grad_norm == straight.metrics.grad_norm
    for (name, p), (_, q) in zip(param_leaves(second.params), param_leaves(straight.params)):
        assert torch.equal(p, q), name
    for a, b in zip(optimizer_tensors(second), optimizer_tensors(straight), strict=True):
        assert torch.equal(a, b)
    if "finetune.optim=adafactor" in overrides:
        assert any("v_row" in s for s in second.optimizer.state_dict()["state"].values())
    assert second.scheduler.state_dict() == straight.scheduler.state_dict()


def test_absent_state_and_left_over_tmp_are_harmless(tmp_path):
    trainer = loop(tmp_path)
    assert not trainer.try_resume()
    stale = tmp_path / "finetune" / "training_state~tmp"
    stale.mkdir(parents=True)
    (stale / "state.pt").write_bytes(b"torn write")
    assert not trainer.try_resume()
    step(trainer, 1)
    trainer.save_checkpoint()
    assert not stale.exists()
    assert sorted(p.name for p in (tmp_path / "finetune").iterdir()) == ["current", "training_state"]
    assert json.loads((tmp_path / "finetune" / "training_state" / "metrics.json").read_text())["completed_steps"] == 1
    again = loop(tmp_path)
    assert again.try_resume() and again.metrics.completed_steps == 1


def test_resume_refuses_another_parameter_set(tmp_path):
    trainer = loop(tmp_path)
    trainer.save_checkpoint()
    lora = loop(tmp_path, "+finetune.lora.enabled=true")
    with pytest.raises(ValueError, match="holds tensors"):
        lora.try_resume()


def test_value_head_is_saved_but_not_exported(tmp_path):
    trainer = loop(tmp_path, value_head=True)
    step(trainer, 1)
    trainer.save_checkpoint()
    state = torch.load(tmp_path / "finetune" / "training_state" / "state.pt", weights_only=True)
    assert "value_head.w" in state["params"]
    exported, _ = load_hf_model(tmp_path / "finetune" / "current", dtype=torch.float32, device="cpu")
    assert "value_head" not in exported
    trunk = {k: v for k, v in trainer.params.items() if k != "value_head"}
    for (name, p), (_, q) in zip(param_leaves(exported), param_leaves(trunk)):
        assert torch.equal(p, q), name


@pytest.mark.parametrize("arch", ["qwen2", "qwen3_tied", "llama"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_export_hf_bytes_equal_jax(tmp_path, arch, dtype):
    """The same weights through each package's ``export_hf``: the
    safetensors files are byte-identical, ``config.json`` equal as JSON;
    JAX's loader reads the port's export back bit for bit."""
    flags = {"qwen2": dict(attention_bias=True, hf_architecture="Qwen2ForCausalLM"),
             "qwen3_tied": dict(qk_norm=True, tie_word_embeddings=True, hf_architecture="Qwen3ForCausalLM"),
             "llama": dict()}[arch]
    jdtype, tdtype = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    shape = dict(vocab_size=80, hidden_size=32, intermediate_size=48, num_layers=3, num_heads=4, num_kv_heads=2,
                 head_dim=8, rope_theta=1_000_000.0, **flags)
    jcfg, tcfg = jt.ModelConfig(dtype=jdtype, **shape), tt.ModelConfig(dtype=tdtype, **shape)
    rng = np.random.default_rng(3)
    tree = jax.tree.map(lambda x: (np.asarray(x, np.float32) + 0.05 * rng.normal(size=x.shape)).astype(np.float32),
                        jt.init_params(jax.random.key(3), jcfg))
    j_dir = j_export_hf(tmp_path / "jax", jax.tree.map(lambda a: jnp.asarray(a, jdtype), tree), jcfg)
    t_params = tt.params_from_numpy(tree, tcfg, "cpu")
    t_params["value_head"] = tt.init_value_head(torch.Generator().manual_seed(0), tcfg, "cpu")
    t_dir = ck.export_hf(tmp_path / "port", t_params, tcfg)
    assert (t_dir / "model.safetensors").read_bytes() == (j_dir / "model.safetensors").read_bytes()
    assert json.loads((t_dir / "config.json").read_text()) == json.loads((j_dir / "config.json").read_text())
    back, back_cfg = jl.load_hf_model(t_dir, dtype=jdtype)
    assert back_cfg.hf_architecture == jcfg.hf_architecture or (arch == "llama" and
                                                               back_cfg.hf_architecture == "LlamaForCausalLM")
    for (name, a), (_, b) in zip(param_leaves(jax.tree.map(np.asarray, back)),
                                 param_leaves({k: v for k, v in t_params.items() if k != "value_head"})):
        assert a.tobytes() == tt_bytes(b), name


def tt_bytes(t: torch.Tensor) -> bytes:
    t = t.detach().contiguous()
    return t.reshape(-1).view(torch.uint8).numpy().tobytes()


def test_export_of_a_vision_tower_raises(tmp_path):
    """A trained ``vision_tower`` exports under Qwen2.5-VL's ``visual.*``
    names with its ``vision_config``, and both packages' ``load_hf_vision``
    read it back bit for bit. (Until the VLM path was ported this export
    raised; the byte comparison with JAX's export is in
    ``test_torch_vlm_trainer.py``.)"""
    from pipelinerl_tpu_torch.models import hf_loader as tl
    from pipelinerl_tpu_torch.models import vision as tv

    params = tt.init_params(torch.Generator().manual_seed(0), MODEL, "cpu")
    vcfg = tv.VisionConfig(hidden_size=16, intermediate_size=32, num_heads=2, depth=2, out_hidden_size=32,
                           patch_size=2, temporal_patch_size=1, window_size=8, fullatt_block_indexes=(1,),
                           dtype=torch.float32)
    params["vision_tower"] = tv.init_vision_params(torch.Generator().manual_seed(1), vcfg, "cpu")
    out = ck.export_hf(tmp_path, params, MODEL, vision_cfg=vcfg)
    assert json.loads((out / "config.json").read_text())["vision_config"]["depth"] == 2
    back, back_cfg = tl.load_hf_vision(out, dtype=torch.float32, device="cpu")
    jback, _ = jl.load_hf_vision(out, dtype=jnp.float32)
    assert back_cfg == vcfg
    ours = dict(param_leaves(params["vision_tower"]))
    for name, t in param_leaves(back):
        assert torch.equal(t, ours[name]), name
    for name, a in param_leaves(jax.tree.map(np.asarray, jback)):
        assert a.tobytes() == tt_bytes(ours[name]), name