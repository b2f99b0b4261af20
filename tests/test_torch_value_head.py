"""The port's value head (``models/transformer.py`` ``init_value_head`` and
``value_predictions``, the value path of ``train/rl_loss.py``) against the
JAX package's ``rl_loss`` with a value head, on identical fp32 weights: the
loss, every metric (``value_loss``, ``value_mean``, ``value_mse``
included) and every gradient, within ``test_torch_rl_loss``'s tolerance.
Also the cases of ``tests/test_value_head.py``, and where ``launch``
creates a value head: on the toy model only, as in the JAX package."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pipelinerl_tpu import launch as jlaunch
from pipelinerl_tpu.config import compose as j_compose
from pipelinerl_tpu.models import transformer as jt
from pipelinerl_tpu.models.hf_fixture import build_hf_checkpoint
from pipelinerl_tpu.train import rl_loss as jl
from pipelinerl_tpu_torch import launch
from pipelinerl_tpu_torch.config import compose
from pipelinerl_tpu_torch.models import transformer as tt
from pipelinerl_tpu_torch.train import rl_loss as tl
from tests.test_torch_rl_loss import KW, assert_match, packed_batch, run_jax, run_port

torch.set_num_threads(1)


def models(seed=0):
    jcfg = jt.ModelConfig(dtype=jnp.float32, **KW)
    jparams = jt.init_params(jax.random.key(seed), jcfg)
    jparams["value_head"] = jt.init_value_head(jax.random.key(seed + 1), jcfg)
    tcfg = tt.ModelConfig(dtype=torch.float32, **KW)
    return jcfg, jparams, tcfg, tt.params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, "cpu")


CASES = {
    "ppo": dict(policy_loss="ppo", value_loss_coef=0.5, epsilon_low=0.2, epsilon_high=0.2),
    "reinforce": dict(policy_loss="reinforce", value_loss_coef=0.5),
    "gspo": dict(policy_loss="gspo", value_loss_coef=0.5, max_segments=8),
    "ppo_coef_zero": dict(policy_loss="ppo", value_loss_coef=0.0),
    "ppo_group_norm_kl": dict(policy_loss="ppo", value_loss_coef=1.0, group_normalization=True, kl_coef=0.1),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_value_path_matches_jax(case):
    jcfg, jparams, tcfg, tparams = models()
    kw = {"batch_size": 3, **CASES[case]}
    batch = packed_batch()
    port = run_port(tcfg, tparams, tl.RLLossConfig(**kw), batch)
    assert_match(port, run_jax(jcfg, jparams, jl.RLLossConfig(**kw), batch))
    _, metrics, grads = port
    assert {"value_loss", "value_mean", "value_mse"} <= set(metrics)
    if kw["value_loss_coef"]:
        assert metrics["value_loss"] > 0 and np.abs(grads["value_head.w"]).sum() > 0
    else:  # advantages detached in the policy term: the head gets nothing
        assert not grads["value_head.w"].any() and not grads["value_head.b"].any()


def test_value_predictions_match_jax():
    jcfg, jparams, _, tparams = models(2)
    hidden = np.random.default_rng(0).normal(size=(2, 5, KW["hidden_size"])).astype(np.float32)
    ours = tt.value_predictions(tparams["value_head"], torch.from_numpy(hidden))
    ref = jt.value_predictions(jparams["value_head"], jnp.asarray(hidden))
    assert ours.shape == (2, 5) and ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


def test_init_value_head_shapes_and_scale():
    cfg = tt.ModelConfig(dtype=torch.bfloat16, **{**KW, "hidden_size": 256})
    head = tt.init_value_head(torch.Generator().manual_seed(0), cfg, "cpu")
    assert head["w"].shape == (256, 1) and head["b"].shape == (1,) and head["w"].dtype == torch.bfloat16
    assert not head["b"].any() and 0.7 < head["w"].float().std().item() * 256**0.5 < 1.3


def test_actor_critic_preset_creates_a_head_on_the_toy_model_only(tmp_path):
    """``finetune=actor_critic`` with ``model_path=toy`` builds a value head
    (kept out of the engine's weights); on an HF checkpoint neither package
    builds one, so the run trains without it (ROADMAP Queue 3: shared with
    the JAX package)."""
    toy = compose("bandit_cpu", [f"output_dir={tmp_path}", "finetune=actor_critic"])
    assert toy.finetune.value_head is True and toy.finetune.rl.value_loss_coef == 0.5
    params, _, _ = launch.build_model(toy, device="cpu")
    assert set(params["value_head"]) == {"w", "b"}
    assert "value_head" not in launch.engine_params(params)

    hf_dir = build_hf_checkpoint(tmp_path / "hf", dtype="float32", hidden_size=32, intermediate_size=64,
                                 num_layers=2, num_heads=2, num_kv_heads=1)
    overrides = [f"output_dir={tmp_path}", f"model_path={hf_dir}", "finetune=actor_critic"]
    params, model_cfg, tokenizer = launch.build_model(compose("test", overrides), device="cpu")
    j_params, _, _ = jlaunch.build_model(j_compose("conf", "test", overrides[:2] + ["finetune.value_head=true"]))
    assert "value_head" not in params and "value_head" not in j_params
    assert model_cfg.valid_vocab == len(tokenizer) == 540
