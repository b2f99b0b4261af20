"""LoRA in the port (``train/lora.py`` and the trainer's LoRA branch)
against the JAX package's: the cases of ``tests/test_lora.py`` (no-op
init, merges that touch the targets only, config validation, adapter-only
training with merged pushes), ``merge_lora`` on the same numpy factors,
and one LoRA trainer step from the same weights and adapters in each
package."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pipelinerl_tpu.config import Config as JConfig
from pipelinerl_tpu.config import compose as j_compose
from pipelinerl_tpu.models import transformer as jt
from pipelinerl_tpu.train import lora as jlora
from pipelinerl_tpu.train import trainer as jtr
from pipelinerl_tpu_torch.config import Config, compose
from pipelinerl_tpu_torch.models import transformer as tt
from pipelinerl_tpu_torch.streams import SingleStreamSpec, StreamWriter
from pipelinerl_tpu_torch.train import lora as tlora
from pipelinerl_tpu_torch.train.trainer import TrainerLoop, param_leaves
from tests.test_torch_trainer import packed, port_batch
from tests.test_trainer_mesh import make_batch_msgs

torch.set_num_threads(1)
KW = dict(vocab_size=64, hidden_size=32, intermediate_size=64, num_layers=2, num_heads=4, num_kv_heads=2)
LORA_OVERRIDES = ["+finetune.lora.enabled=true", "+finetune.lora.r=4", "+finetune.lora.alpha=8",
                  '+finetune.lora.target_modules=["wq","wv","wdown"]']


def base_params(dtype=torch.float32):
    cfg = tt.ModelConfig(dtype=dtype, **KW)
    return tt.init_params(torch.Generator().manual_seed(0), cfg, "cpu"), cfg


def test_lora_init_is_identity():
    params, cfg = base_params()
    lcfg = tlora.LoRAConfig(enabled=True, r=4, alpha=8, target_modules=("wq", "wv"))
    adapters = tlora.init_lora_params(torch.Generator().manual_seed(1), params, lcfg)
    assert adapters["layers"]["wq_A"].shape == (2, 32, 4) and adapters["layers"]["wv_B"].shape == (2, 4, 16)
    assert adapters["layers"]["wq_A"].abs().sum() > 0 and not adapters["layers"]["wq_B"].any()
    merged = tlora.merge_lora(params, adapters, lcfg)
    ids, pos, seg = torch.arange(1, 9)[None], torch.arange(8)[None], torch.zeros((1, 8), dtype=torch.int32)
    assert torch.equal(tt.forward(params, cfg, ids, pos, seg), tt.forward(merged, cfg, ids, pos, seg))


def test_lora_merge_changes_targets_only():
    params, _ = base_params()
    lcfg = tlora.LoRAConfig(enabled=True, r=4, alpha=8, target_modules=("wq",))
    adapters = tlora.init_lora_params(torch.Generator().manual_seed(2), params, lcfg)
    adapters["layers"]["wq_B"] = torch.ones_like(adapters["layers"]["wq_B"])
    merged = tlora.merge_lora(params, adapters, lcfg)
    assert not torch.allclose(merged["layers"]["wq"], params["layers"]["wq"])
    assert merged["layers"]["wk"] is params["layers"]["wk"] and merged["embed"] is params["embed"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_merge_matches_jax(dtype):
    """Both packages' ``merge_lora`` on the same numpy base and factors:
    the product and the sum in fp32, cast back. fp32: rtol 1e-6 (the
    r-term product sums in another order); bf16: the casts may round one
    ulp apart where the fp32 sums differ, so atol one bf16 ulp of the
    largest entry."""
    jdtype, tdtype = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    rng = np.random.default_rng(0)
    targets = ("wq", "wk", "wup", "wdown")
    tree = jax.tree.map(np.asarray, jt.init_params(jax.random.key(0), jt.ModelConfig(dtype=jnp.float32, **KW)))
    factors = {}
    for name in targets:
        L, d_in, d_out = tree["layers"][name].shape
        factors[f"{name}_A"] = rng.normal(size=(L, d_in, 4)).astype(np.float32)
        factors[f"{name}_B"] = rng.normal(size=(L, 4, d_out)).astype(np.float32) * 0.1
    jl = jlora.LoRAConfig(enabled=True, r=4, alpha=8, target_modules=targets)
    tl = tlora.LoRAConfig(enabled=True, r=4, alpha=8, target_modules=targets)
    j_merged = jlora.merge_lora(jax.tree.map(lambda a: jnp.asarray(a, jdtype), tree),
                                {"layers": {k: jnp.asarray(v, jdtype) for k, v in factors.items()}}, jl)
    tcfg = tt.ModelConfig(dtype=tdtype, **KW)
    t_merged = tlora.merge_lora(tt.params_from_numpy(tree, tcfg, "cpu"),
                                {"layers": {k: torch.from_numpy(v).to(tdtype) for k, v in factors.items()}}, tl)
    for name in targets:
        ours = t_merged["layers"][name].float().numpy()
        ref = np.asarray(j_merged["layers"][name], np.float32)
        assert t_merged["layers"][name].dtype == tdtype
        if dtype == "float32":
            np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-6, err_msg=name)
        else:
            np.testing.assert_allclose(ours, ref, rtol=0, atol=2.0**-7 * float(np.abs(ref).max()), err_msg=name)


def test_lora_config_validation():
    assert not tlora.lora_config_from(Config({})).enabled
    node = {"lora": {"enabled": True, "r": 8, "alpha": 16, "target_modules": ["wq"]}}
    lcfg, ref = tlora.lora_config_from(Config(node)), jlora.lora_config_from(JConfig(node))
    assert lcfg.enabled and lcfg.scaling == 2.0 and lcfg.target_modules == ("wq",)
    assert (lcfg.r, lcfg.alpha, lcfg.target_modules, lcfg.scaling) == (ref.r, ref.alpha, ref.target_modules,
                                                                       ref.scaling)
    with pytest.raises(ValueError):
        tlora.lora_config_from(Config({"lora": {"enabled": True, "target_modules": ["nope"]}}))


def test_trainer_trains_only_adapters(tmp_path):
    """``TrainerLoop.run`` on a LoRA config: the optimizer holds only the
    adapters, B moves, the base stays bit for bit, and the pushes carry
    merged full weights equal to ``merge_lora`` of the final adapters."""
    params, model_cfg = base_params()
    before = {name: p.clone() for name, p in param_leaves(params)}
    cfg = compose("base", [f"output_dir={tmp_path}", "finetune.samples_per_step=4", "finetune.max_train_steps=1",
                           "finetune.seq_length=64", "finetune.learning_rate=1e-2", "finetune.num_warmup_steps=0",
                           "finetune.gradient_checkpointing=false", "finetune.save_checkpoint_steps=0",
                           *LORA_OVERRIDES])
    pushed = []
    trainer = TrainerLoop(cfg, params, model_cfg, str(tmp_path), weight_update_cb=lambda p, v: pushed.append((p, v)))
    assert sorted(trainer.params["layers"]) == ["wdown_A", "wdown_B", "wq_A", "wq_B", "wv_A", "wv_B"]
    assert sum(len(g["params"]) for g in trainer.optimizer.param_groups) == 6
    writer = StreamWriter(SingleStreamSpec(exp_path=str(tmp_path), topic="training_data"))
    for msg in make_batch_msgs(2, rng=np.random.default_rng(1), vocab=60):
        writer.write(msg)
    writer.close()
    assert trainer.run(max_steps=1).completed_steps == 1
    assert trainer.params["layers"]["wq_B"].abs().sum() > 0
    for name, p in param_leaves(trainer.frozen_params):
        assert torch.equal(p, before[name]) and not p.requires_grad, name
    merged, version = pushed[-1]
    assert version == 4 and "wq" in merged["layers"] and "wq_A" not in merged["layers"]
    with torch.no_grad():
        expected = tlora.merge_lora(trainer.frozen_params, trainer.params, trainer.lora_cfg)
    for (name, p), (_, q) in zip(param_leaves(merged), param_leaves(expected)):
        assert torch.equal(p, q), name


def test_one_lora_step_matches_jax(tmp_path):
    """bandit_cpu with LoRA in each package, the same base weights and the
    same adapters (JAX's init, copied into the port's): the loss, the
    grad norm and the adapters after one step. Tolerance as
    ``test_torch_trainer.test_one_trainer_step_matches_jax``: loss rtol
    1e-5, grad norm rtol 1e-4, adapters atol 1e-4 (2.5 % of the first Adam
    step)."""
    overrides = ["output_dir=/unused", "finetune.save_checkpoint_steps=0", *LORA_OVERRIDES]
    jcfg, tcfg = j_compose("conf", "bandit_cpu", overrides), compose("bandit_cpu", overrides)
    toy = jcfg.toy_model
    shape = dict(vocab_size=260, hidden_size=toy.hidden_size, intermediate_size=toy.intermediate_size,
                 num_layers=toy.num_layers, num_heads=toy.num_heads, num_kv_heads=toy.num_kv_heads)
    jmc, tmc = jt.ModelConfig(dtype=jnp.float32, **shape), tt.ModelConfig(dtype=torch.float32, **shape)
    jparams = jt.init_params(jax.random.key(0), jmc)
    tparams = tt.params_from_numpy(jax.tree.map(np.asarray, jparams), tmc, "cpu")
    jloop = jtr.TrainerLoop(jcfg, jparams, jmc, str(tmp_path / "j"))
    tloop = TrainerLoop(tcfg, tparams, tmc, str(tmp_path / "t"))
    with torch.no_grad():
        for name, p in param_leaves(tloop.params):
            p.copy_(torch.from_numpy(np.array(dict(param_leaves(jloop.params))[name])))
    batch = packed(1, L=tcfg.finetune.seq_length)
    jm = jloop.train_pass(batch)
    tm = tloop.train_pass(port_batch(batch))
    assert tm["loss"] == pytest.approx(jm["loss"], rel=1e-5)
    jloop.optimizer_step()
    tloop.optimizer_step()
    assert tloop.metrics.grad_norm == pytest.approx(jloop.metrics.grad_norm, rel=1e-4)
    ref = dict(param_leaves(jloop.params))  # jax returns its dicts in sorted key order
    assert sorted(ref) == sorted(name for name, _ in param_leaves(tloop.params))
    for name, p in param_leaves(tloop.params):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(ref[name]), rtol=0, atol=1e-4, err_msg=name)
