"""The PyTorch port's transformer against the JAX package's, on identical
fp32 weights carried across as numpy (plain attention paths)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pipelinerl_tpu.models import transformer as jt
from pipelinerl_tpu_torch.models import transformer as tt

torch.set_num_threads(1)
RTOL, ATOL = 1e-5, 1e-4  # fp32 on both sides; sums run in another order


def make_models(seed, H=4, K=2, Dh=8, bias=True, qk_norm=False, valid_vocab=None):
    kw = dict(vocab_size=128, hidden_size=32, intermediate_size=64, num_layers=2,
              num_heads=H, num_kv_heads=K, head_dim=Dh, rope_theta=10_000.0,
              attention_bias=bias, qk_norm=qk_norm, valid_vocab=valid_vocab)
    jcfg = jt.ModelConfig(dtype=jnp.float32, **kw)
    tcfg = tt.ModelConfig(dtype=torch.float32, **kw)
    rng = np.random.default_rng(seed)
    # perturb every leaf, so biases and norm weights are not 0 and 1
    tree = jax.tree.map(
        lambda x: (np.asarray(x) + 0.05 * rng.normal(size=x.shape)).astype(np.float32),
        jt.init_params(jax.random.key(seed), jcfg),
    )
    jparams = jax.tree.map(jnp.asarray, tree)
    return jcfg, jparams, tcfg, tt.params_from_numpy(tree, tcfg, "cpu")


def packed_row(rng, B, L, n_segs, V=128):
    ids = rng.integers(0, V, (B, L))
    seg = np.zeros((B, L), np.int32)
    pos = np.zeros((B, L), np.int32)
    for b in range(B):
        bounds = sorted(rng.choice(np.arange(1, L), size=n_segs - 1, replace=False))
        prev = 0
        for i, e in enumerate(list(bounds) + [L]):
            seg[b, prev:e] = i
            pos[b, prev:e] = np.arange(e - prev)
            prev = e
    return ids, pos, seg


@pytest.mark.parametrize(
    "H,K,Dh,bias,qk_norm,valid_vocab",
    [(4, 2, 8, True, False, None), (4, 2, 8, True, True, 100), (7, 1, 16, False, False, None)],
)
def test_forward_matches_jax(H, K, Dh, bias, qk_norm, valid_vocab):
    jcfg, jp, tcfg, tp = make_models(0, H, K, Dh, bias, qk_norm, valid_vocab)
    ids, pos, seg = packed_row(np.random.default_rng(1), B=2, L=24, n_segs=3)
    j_logits, (jk, jv) = jt.forward(jp, jcfg, jnp.asarray(ids), jnp.asarray(pos), jnp.asarray(seg),
                                    return_kv=True)
    t_logits, (tk, tv) = tt.forward(tp, tcfg, torch.from_numpy(ids), torch.from_numpy(pos),
                                    torch.from_numpy(seg), return_kv=True)
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=RTOL, atol=ATOL)
    j_hidden = jt.forward(jp, jcfg, jnp.asarray(ids), jnp.asarray(pos), jnp.asarray(seg),
                          skip_unembed=True)
    t_hidden = tt.forward(tp, tcfg, torch.from_numpy(ids), torch.from_numpy(pos),
                          torch.from_numpy(seg), skip_unembed=True)
    np.testing.assert_allclose(t_hidden.numpy(), np.asarray(j_hidden), rtol=RTOL, atol=ATOL)


def test_packed_row_equals_separate_runs():
    _, _, tcfg, tp = make_models(2)
    lens = [5, 9, 4]
    rng = np.random.default_rng(3)
    seqs = [rng.integers(0, 128, n) for n in lens]
    ids = np.concatenate(seqs)[None]
    seg = np.concatenate([np.full(n, i, np.int32) for i, n in enumerate(lens)])[None]
    pos = np.concatenate([np.arange(n) for n in lens])[None]
    packed = tt.forward(tp, tcfg, torch.from_numpy(ids), torch.from_numpy(pos), torch.from_numpy(seg))
    off = 0
    for s in seqs:
        n = len(s)
        alone = tt.forward(tp, tcfg, torch.from_numpy(s[None]), torch.arange(n)[None],
                           torch.zeros((1, n), dtype=torch.int32))
        np.testing.assert_allclose(packed[0, off : off + n].numpy(), alone[0].numpy(), rtol=RTOL, atol=ATOL)
        off += n


@pytest.mark.parametrize("step", [0, 3])
def test_decode_step_staged_matches_jax(step):
    jcfg, jp, tcfg, tp = make_models(4, qk_norm=True)
    rng = np.random.default_rng(5)
    L, S, T, W, K, Dh = 2, 3, 12, 4, 2, 8
    mk = lambda *s: rng.normal(size=s).astype(np.float32)
    kc, vc, ks, vs = mk(L, S, T, K, Dh), mk(L, S, T, K, Dh), mk(L, W, S, K, Dh), mk(L, W, S, K, Dh)
    lens = np.array([0, 5, 12], np.int32)
    tokens = rng.integers(0, 128, S)
    positions = lens + step
    j_out = jt.decode_step_staged(
        jp, jcfg, jnp.asarray(tokens), jnp.asarray(positions), jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(lens), jnp.asarray(ks), jnp.asarray(vs), jnp.asarray(step),
    )
    t_out = tt.decode_step_staged(
        tp, tcfg, torch.from_numpy(tokens), torch.from_numpy(positions), torch.from_numpy(kc),
        torch.from_numpy(vc), torch.from_numpy(lens), torch.from_numpy(ks), torch.from_numpy(vs), step,
    )
    for a, b in zip(t_out, j_out):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=ATOL)


def test_decode_equals_forward_last_position():
    """A decode step over a cache written by the forward reproduces the
    forward's logits at the next position."""
    _, _, tcfg, tp = make_models(6)
    seq = torch.from_numpy(np.random.default_rng(7).integers(0, 128, 9))
    n = 8
    full = tt.forward(tp, tcfg, seq[None], torch.arange(9)[None], torch.zeros((1, 9), dtype=torch.int32))
    _, (k, v) = tt.forward(tp, tcfg, seq[None, :n], torch.arange(n)[None],
                           torch.zeros((1, n), dtype=torch.int32), return_kv=True)
    L, W = tcfg.num_layers, 2
    band = torch.zeros((L, W, 1, tcfg.num_kv_heads, tcfg.head_dim_))
    logits, _, _ = tt.decode_step_staged(
        tp, tcfg, seq[n:n + 1], torch.tensor([n]), k, v, torch.tensor([n], dtype=torch.int32),
        band, band, 0,
    )
    np.testing.assert_allclose(logits[0].numpy(), full[0, n].numpy(), rtol=RTOL, atol=ATOL)


def test_lm_head_masks_padded_vocab_and_params_from_bf16():
    jcfg, _, tcfg, _ = make_models(8, valid_vocab=100)
    tree = jax.tree.map(np.asarray, jt.init_params(jax.random.key(8), jcfg))
    bf_tree = jax.tree.map(lambda x: np.asarray(jnp.asarray(x, jnp.bfloat16)), tree)
    tp = tt.params_from_numpy(bf_tree, tcfg, "cpu")
    np.testing.assert_array_equal(
        tp["embed"].numpy(), np.asarray(jnp.asarray(tree["embed"], jnp.bfloat16), np.float32)
    )
    logits = tt.lm_head_logits(tp, tcfg, torch.randn(3, 32))
    assert logits.dtype == torch.float32
    assert bool((logits[:, 100:] == -1e30).all()) and bool((logits[:, :100] > -1e29).all())


@pytest.mark.parametrize("H,K,Dh,qk_norm", [(4, 2, 8, False), (4, 2, 8, True), (7, 1, 16, False)])
def test_forward_extend_matches_jax(H, K, Dh, qk_norm):
    """Tails against cached prefixes of 10, 4 and 0 valid rows out of 10 (the
    rest pad, masked by segment), at global positions prefix_len + i."""
    jcfg, jp, tcfg, tp = make_models(9, H, K, Dh, qk_norm=qk_norm)
    rng = np.random.default_rng(10)
    B, Lt, Pfx, L = 3, 6, 10, 2
    ids = rng.integers(0, 128, (B, Lt))
    prefix_len = np.array([10, 4, 0], np.int32)
    pos = prefix_len[:, None] + np.arange(Lt)[None]
    kp, vp = (rng.normal(size=(L, B, Pfx, K, Dh)).astype(np.float32) for _ in range(2))
    for skip in (False, True):
        j_out, (jk, jv) = jt.forward_extend(jp, jcfg, jnp.asarray(ids), jnp.asarray(pos), jnp.asarray(kp),
                                            jnp.asarray(vp), jnp.asarray(prefix_len), skip_unembed=skip)
        t_out, (tk, tv) = tt.forward_extend(tp, tcfg, torch.from_numpy(ids), torch.from_numpy(pos), torch.from_numpy(kp),
                                            torch.from_numpy(vp), torch.from_numpy(prefix_len), skip_unembed=skip)
        np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=RTOL, atol=ATOL)


def test_forward_extend_equals_forward_over_the_whole_prompt():
    """Prefill of a prompt's head, then forward_extend of its tail against the
    head's K/V, reproduces the full forward's logits on the tail."""
    _, _, tcfg, tp = make_models(11)
    seq = torch.from_numpy(np.random.default_rng(12).integers(0, 128, 13))[None]
    zeros = lambda n: torch.zeros((1, n), dtype=torch.int32)
    full = tt.forward(tp, tcfg, seq, torch.arange(13)[None], zeros(13))
    _, (k, v) = tt.forward(tp, tcfg, seq[:, :8], torch.arange(8)[None], zeros(8), return_kv=True)
    tail, _ = tt.forward_extend(tp, tcfg, seq[:, 8:], torch.arange(8, 13)[None], k, v, torch.tensor([8]))
    np.testing.assert_allclose(tail[0].numpy(), full[0, 8:].numpy(), rtol=RTOL, atol=ATOL)
