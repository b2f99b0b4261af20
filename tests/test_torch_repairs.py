"""Two faults of the port against the reference, repaired: the attention
names ``blockwise`` and ``cp`` that the JAX trainer and engine accept, and
``finetune.memory_debug`` / ``finetune.profile``, which the JAX trainer
reads and the port now refuses, naming the item that ports them."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pipelinerl_tpu.models import transformer as jt
from pipelinerl_tpu.ops.blockwise_attention import mha_packed_blockwise
from pipelinerl_tpu_torch.config import compose
from pipelinerl_tpu_torch.inference import engine as te
from pipelinerl_tpu_torch.launch import validate_config
from pipelinerl_tpu_torch.models import transformer as tt
from pipelinerl_tpu_torch.ops.gqa_attention import mha_packed_gqa
from pipelinerl_tpu_torch.train import trainer as ttr
from tests.test_torch_transformer import make_models, packed_row

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-4)  # fp32 both sides; blockwise sums by tiles, in another order


@pytest.mark.parametrize("H,K,q_offset,Lq", [(4, 4, 0, 192), (4, 2, 0, 192), (6, 2, 64, 128)])
def test_blockwise_route_matches_mha_packed_blockwise(H, K, q_offset, Lq):
    """What ``attn_impl="blockwise"`` runs (the GQA autograd function; its
    plain versions on the CPU) against JAX's ``mha_packed_blockwise`` on the
    same fp32 inputs from a seed, small blocks so that several tiles run:
    output and the gradients of q, k and v, a query block at an offset
    (the context-parallel shard's layout) included."""
    rng = np.random.default_rng(H * 10 + K + q_offset)
    B, Lkv, Dh = 2, q_offset + Lq, 16
    q = rng.normal(size=(B, Lq, H, Dh)).astype(np.float32)
    k = rng.normal(size=(B, Lkv, K, Dh)).astype(np.float32)
    v = rng.normal(size=(B, Lkv, K, Dh)).astype(np.float32)
    do = rng.normal(size=(B, Lq, H, Dh)).astype(np.float32)
    kv_seg = np.sort(rng.integers(0, 4, (B, Lkv)), axis=1).astype(np.int32)
    q_seg = kv_seg[:, q_offset:]

    def jf(q_, k_, v_):
        return mha_packed_blockwise(q_, k_, v_, jnp.asarray(q_seg), jnp.asarray(kv_seg), q_offset, None, 64, 32)

    j_out, vjp = jax.vjp(jf, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    j_grads = vjp(jnp.asarray(do))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out, _ = mha_packed_gqa(*leaves, torch.from_numpy(np.ascontiguousarray(q_seg)), torch.from_numpy(kv_seg),
                            q_offset)
    out.backward(torch.from_numpy(do))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out), **TOL)
    for leaf, ref in zip(leaves, j_grads):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("name", ["blockwise", "cp"])
def test_forward_under_blockwise_and_cp_matches_jax(name):
    """The model's forward under each name against the JAX forward under
    the same name: ``blockwise`` runs JAX's blockwise kernel there and the
    port's GQA route here; ``cp`` (no cp axis) runs the plain attention in
    both."""
    jcfg, jp, tcfg, tp = make_models(3)
    ids, pos, seg = packed_row(np.random.default_rng(4), B=2, L=24, n_segs=3)
    j_logits = jt.forward(jp, jcfg, jnp.asarray(ids), jnp.asarray(pos), jnp.asarray(seg), attn_impl=name)
    impl = ttr.resolve_attn_impl(name, 24, torch.device("cpu"))
    t_logits = tt.forward(tp, tcfg, torch.from_numpy(ids), torch.from_numpy(pos), torch.from_numpy(seg),
                          attn_impl=impl)
    np.testing.assert_allclose(t_logits.detach().numpy(), np.asarray(j_logits), rtol=1e-5, atol=1e-4)


def test_trainer_and_engine_accept_blockwise_and_cp():
    """The trainer resolves ``cp`` to the plain attention (the JAX trainer
    does so without a cp axis) and keeps ``blockwise``, which ``forward``
    routes to the GQA kernels; the engine runs ``blockwise`` and ``flash``
    on the GQA route and ``cp`` on the plain one, as the JAX engine's
    forward does, where it raised before."""
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert ttr.resolve_attn_impl("cp", 32768, cuda) == "xla"
    assert ttr.resolve_attn_impl("blockwise", 4096, cpu) == "blockwise"
    assert ttr.resolve_attn_impl("auto", 4096, cuda) == "gqa"
    assert ttr.resolve_attn_impl("auto", 4096, cpu) == "xla"
    for name, want in (("blockwise", "gqa"), ("flash", "gqa"), ("cp", "xla"), ("auto", "gqa")):
        assert te._resolve_impl(name, cuda, "gqa") == want
    with pytest.raises(ValueError, match="unknown attention"):
        te._resolve_impl("nope", cuda, "gqa")
    cfg = tt.ModelConfig(vocab_size=64, hidden_size=16, intermediate_size=32, num_layers=1, num_heads=2,
                         num_kv_heads=1, dtype=torch.float32)
    params = tt.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    for name, want in (("blockwise", "gqa"), ("cp", "xla")):
        engine = te.InferenceEngine(params, cfg, te.EngineConfig(max_slots=2, max_len=32, prefill_buckets=(8,),
                                                                 cache_dtype=torch.float32, attn_impl=name),
                                    eos_token_id=1, device="cpu")
        assert engine.attn_impl == want


@pytest.mark.parametrize("key", ["memory_debug", "profile"])
def test_memory_debug_and_profile_are_refused_naming_item_11(key):
    """JAX's trainer builds a memory debugger and a step profiler from these
    keys; the port refuses ``enabled: true`` where it used to ignore it."""
    cfg = compose("bandit_cpu", ["output_dir=/tmp/unused", f"+finetune.{key}.enabled=false"])
    validate_config(cfg)
    cfg = compose("bandit_cpu", ["output_dir=/tmp/unused", f"+finetune.{key}.enabled=true"])
    with pytest.raises(ValueError, match=f"finetune.{key}.enabled.*item 11"):
        validate_config(cfg)
