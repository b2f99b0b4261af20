"""The port's ``rl_loss`` against the JAX package's on identical fp32
weights (``params_from_numpy``) and one packed batch: the loss, every
metric, and the gradient of every parameter.

Tolerance, fp32 on both sides: rtol 1e-4, atol 1e-6 on the loss and the
metrics; on each gradient tensor rtol 1e-4 plus 1e-5 of the tensor's
largest magnitude. The two frameworks sum in other orders, which costs bits
relative to the largest terms of a sum, and some gradients (the key bias,
nearly shift-invariant under softmax) are small differences of large
terms."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import pipelinerl_tpu.ops.gqa_attention as jgqa
from pipelinerl_tpu.models import transformer as jt
from pipelinerl_tpu.train import rl_loss as jl
from pipelinerl_tpu.train.advantages import populate_rl_data, prepare_rl_fields
from pipelinerl_tpu.train.packing import make_sentinel_batch, pack_samples
from pipelinerl_tpu_torch.models import transformer as tt
from pipelinerl_tpu_torch.train import rl_loss as tl
from pipelinerl_tpu_torch.train.trainer import batch_to_tensors, param_leaves

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-6)
EOS = 9
KW = dict(vocab_size=64, hidden_size=32, intermediate_size=64, num_layers=2, num_heads=4,
          num_kv_heads=2, attention_bias=True, valid_vocab=60)


def models(seed=0):
    jcfg = jt.ModelConfig(dtype=jnp.float32, **KW)
    jparams = jt.init_params(jax.random.key(seed), jcfg)
    tcfg = tt.ModelConfig(dtype=torch.float32, **KW)
    return jcfg, jparams, tcfg, tt.params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, "cpu")


def packed_batch(L=48, rewards=(1.0, 0.0, 0.5), seed=0, sentinel=False):
    """Samples of one group, one of them cut at its length limit (overflow),
    with reference logprobs, packed into one [1, L] row."""
    if sentinel:
        return make_sentinel_batch(L, EOS)
    rng = np.random.default_rng(seed)
    samples = []
    for i, r in enumerate(rewards):
        n_prompt, n_out = 3, 8 + 2 * i
        ids = rng.integers(1, 60, n_prompt + n_out).tolist()
        samples.append(prepare_rl_fields({
            "input_ids": ids,
            "labels": [-100] * n_prompt + ids[n_prompt:],
            "reward": r,
            "logprobs": (-0.3 - 0.5 * rng.random(n_out)).tolist(),
            "ref_logprobs": (-0.4 - 0.5 * rng.random(n_out)).tolist(),
            "group_id": "g",
            "rollout_index": i,
            "step_index": 0,
            "finished": i != 1,
            "finish_reason": "length" if i == 1 else "stop",
            "model_version": 0,
        }))
    populate_rl_data(samples, EOS)
    return pack_samples(samples, L, EOS)


def run_jax(jcfg, jparams, loss_cfg, batch, sentinel=0.0, attn_impl="xla", logits_chunk=None):
    arrays = {k: jnp.asarray(v) for k, v in batch.arrays().items()}

    def f(p):
        return jl.rl_loss(p, jcfg, loss_cfg, arrays, jnp.asarray(3.0), 10, jnp.asarray(sentinel),
                          remat=False, attn_impl=attn_impl, logits_chunk=logits_chunk)

    (loss, metrics), grads = jax.value_and_grad(f, has_aux=True)(jparams)
    leaves = {".".join(k.key for k in path): np.asarray(v) for path, v in jax.tree_util.tree_leaves_with_path(grads)}
    return float(loss), {k: float(v) for k, v in metrics.items()}, leaves


def run_port(tcfg, tparams, loss_cfg, batch, sentinel=0.0, remat=False, attn_impl="xla", logits_chunk=None):
    params = {k: ({n: t.clone().requires_grad_() for n, t in v.items()} if isinstance(v, dict)
                  else v.clone().requires_grad_()) for k, v in tparams.items()}
    loss, metrics = tl.rl_loss(params, tcfg, loss_cfg, batch_to_tensors(batch, "cpu"), 3.0, 10, sentinel,
                               remat=remat, attn_impl=attn_impl, logits_chunk=logits_chunk)
    loss.backward()
    grads = {name: p.grad.numpy() for name, p in param_leaves(params)}
    return loss.detach().item(), {k: float(v.detach()) for k, v in metrics.items()}, grads


def assert_match(port, ref):
    loss, metrics, grads = port
    rloss, rmetrics, rgrads = ref
    np.testing.assert_allclose(loss, rloss, **TOL)
    assert set(metrics) == set(rmetrics)
    for k in rmetrics:
        np.testing.assert_allclose(metrics[k], rmetrics[k], err_msg=k, **TOL)
    assert set(grads) == set(rgrads)
    for name, g in grads.items():
        ref = rgrads[name]
        np.testing.assert_allclose(g, ref, rtol=1e-4, atol=1e-5 * float(np.abs(ref).max()), err_msg=name)


LOSS_CASES = {
    "reinforce": dict(policy_loss="reinforce"),
    "ppo": dict(policy_loss="ppo"),
    "gspo": dict(policy_loss="gspo", max_segments=8),
    "kl": dict(policy_loss="reinforce", kl_coef=0.3, final_kl_coef=0.1),
    "entropy": dict(policy_loss="ppo", entropy_bonus=0.05, final_entropy_bonus=0.01),
    "overlong": dict(policy_loss="reinforce", overlong_filtering=True),
    "group_norm": dict(policy_loss="gspo", group_normalization=True, max_segments=8),
    "temperature_relu": dict(policy_loss="ppo", temperature=0.7, relu_log_p_weights=True),
}


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_rl_loss_matches_jax(case):
    jcfg, jparams, tcfg, tparams = models()
    kw = {"batch_size": 3, **LOSS_CASES[case]}
    batch = packed_batch()
    assert_match(run_port(tcfg, tparams, tl.RLLossConfig(**kw), batch),
                 run_jax(jcfg, jparams, jl.RLLossConfig(**kw), batch))


def test_sentinel_zeroes_loss_and_grads():
    jcfg, jparams, tcfg, tparams = models()
    batch = packed_batch(sentinel=True)
    port = run_port(tcfg, tparams, tl.RLLossConfig(batch_size=3), batch, sentinel=1.0)
    assert port[0] == 0.0 and all(not g.any() for g in port[2].values())
    assert_match(port, run_jax(jcfg, jparams, jl.RLLossConfig(batch_size=3), batch, sentinel=1.0))


@pytest.mark.parametrize("entropy_bonus", [0.0, 0.05])
def test_chunked_logits_matches_full(entropy_bonus):
    """``logits_chunk`` (the long-row unembed in pieces under checkpoint)
    against the full logits, and against the JAX chunked scan."""
    jcfg, jparams, tcfg, tparams = models(1)
    kw = dict(policy_loss="gspo", batch_size=3, max_segments=8, kl_coef=0.1, entropy_bonus=entropy_bonus)
    batch = packed_batch(L=48)
    full = run_port(tcfg, tparams, tl.RLLossConfig(**kw), batch)
    chunked = run_port(tcfg, tparams, tl.RLLossConfig(**kw), batch, logits_chunk=16)
    assert_match(chunked, full)
    assert_match(chunked, run_jax(jcfg, jparams, jl.RLLossConfig(**kw), batch, logits_chunk=16))


@pytest.mark.parametrize("remat", [True, "mlp"])
def test_remat_matches_none(remat):
    _, _, tcfg, tparams = models(2)
    cfg = tl.RLLossConfig(batch_size=3, entropy_bonus=0.02)
    batch = packed_batch(seed=2)
    assert_match(run_port(tcfg, tparams, cfg, batch, remat=remat), run_port(tcfg, tparams, cfg, batch))


def test_gqa_attn_impl_matches_xla_and_jax():
    """attn_impl="gqa" (the autograd function's plain forward and backward
    on the CPU) against the plain attention, and against the JAX Pallas
    kernels in interpret mode (L = 256: the JAX wrapper's smallest kv block
    is 128)."""
    jcfg, jparams, tcfg, tparams = models(3)
    cfg_kw = dict(batch_size=4, policy_loss="reinforce")
    batch = packed_batch(L=256, rewards=(1.0, 0.0, 0.5, 2.0), seed=3)
    gqa = run_port(tcfg, tparams, tl.RLLossConfig(**cfg_kw), batch, attn_impl="gqa")
    assert_match(gqa, run_port(tcfg, tparams, tl.RLLossConfig(**cfg_kw), batch, attn_impl="xla"))
    jgqa.INTERPRET = True
    try:
        ref = run_jax(jcfg, jparams, jl.RLLossConfig(**cfg_kw), batch, attn_impl="gqa")
    finally:
        jgqa.INTERPRET = False
    assert_match(gqa, ref)


def test_token_logprobs_match_jax():
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(2, 12, 64)).astype(np.float32)
    ids = rng.integers(0, 64, (2, 12)).astype(np.int32)
    ref = jl.token_logprobs_from_logits(jnp.asarray(logits), jnp.asarray(ids), 0.8)
    got = tl.token_logprobs_from_logits(torch.from_numpy(logits), torch.from_numpy(ids).long(), 0.8)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
