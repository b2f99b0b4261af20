"""The port's GQA packed attention forward (plain version of the CUDA
kernel) against the JAX package's Pallas forward in interpret mode: out and
lse, in fp32."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import pipelinerl_tpu.ops.gqa_attention as jgqa
from pipelinerl_tpu.ops.attention import mha_packed as j_mha_packed
from pipelinerl_tpu_torch.ops import gqa_attention as tgqa
from pipelinerl_tpu_torch.ops.attention import mha_packed as t_mha_packed

torch.set_num_threads(1)
ATOL = 1e-4  # fp32 on both sides (the kernel's P stays fp32 for fp32 v)


@pytest.fixture(autouse=True)
def _interpret():
    jgqa.INTERPRET = True
    yield
    jgqa.INTERPRET = False


def segments(rng, B, L, n_segs):
    seg = np.zeros((B, L), np.int32)
    for b in range(B):
        bounds = sorted(rng.choice(np.arange(1, L), size=n_segs - 1, replace=False))
        prev = 0
        for i, e in enumerate(list(bounds) + [L]):
            seg[b, prev:e] = i
            prev = e
    return seg


def jax_fwd(q, k, v, q_seg, kv_seg, q_offset, bq, m_blk):
    """The Pallas forward: out [B, Lq, H, Dh], lse in the port's [B, Lq, K, G]."""
    B, Lq, H, Dh = q.shape
    K = k.shape[2]
    out, lse = jgqa._fwd_call(
        jnp.asarray(q.reshape(B, Lq, K, H // K, Dh)), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(q_seg), jnp.asarray(kv_seg), q_offset, Dh**-0.5, bq, m_blk,
    )
    return np.asarray(out).reshape(B, Lq, H, Dh), np.asarray(lse).transpose(0, 3, 1, 2)


def port_fwd(q, k, v, q_seg, kv_seg, q_offset):
    out, lse = tgqa.mha_packed_gqa(*(torch.from_numpy(x) for x in (q, k, v, q_seg, kv_seg)), q_offset)
    return out.numpy(), lse.numpy()


@pytest.mark.parametrize(
    "B,Lq,Lkv,H,K,Dh,n_segs,q_offset",
    [
        (1, 64, 64, 7, 1, 16, 3, 0),  # G = 7, the production fold
        (2, 64, 64, 4, 2, 8, 2, 0),  # batch 2, several segments
        (1, 32, 96, 4, 2, 8, 2, 64),  # q_offset > 0 with Lq < Lkv
    ],
)
def test_forward_matches_pallas(B, Lq, Lkv, H, K, Dh, n_segs, q_offset):
    rng = np.random.default_rng(Lq + Lkv + H)
    q = rng.normal(size=(B, Lq, H, Dh)).astype(np.float32)
    k = rng.normal(size=(B, Lkv, K, Dh)).astype(np.float32)
    v = rng.normal(size=(B, Lkv, K, Dh)).astype(np.float32)
    kv_seg = segments(rng, B, Lkv, n_segs)
    q_seg = kv_seg[:, q_offset : q_offset + Lq].copy()
    j_out, j_lse = jax_fwd(q, k, v, q_seg, kv_seg, q_offset, bq=16, m_blk=32)
    t_out, t_lse = port_fwd(q, k, v, q_seg, kv_seg, q_offset)
    np.testing.assert_allclose(t_out, j_out, rtol=0, atol=ATOL)
    np.testing.assert_allclose(t_lse, j_lse, rtol=0, atol=ATOL)


def test_fully_masked_row():
    """A query whose segment has no key gets lse = -1e30 and out = 0, as in
    the Pallas kernel."""
    rng = np.random.default_rng(9)
    B, L, H, K, Dh = 1, 32, 4, 2, 8
    q = rng.normal(size=(B, L, H, Dh)).astype(np.float32)
    k = rng.normal(size=(B, L, K, Dh)).astype(np.float32)
    v = rng.normal(size=(B, L, K, Dh)).astype(np.float32)
    kv_seg = np.zeros((B, L), np.int32)
    q_seg = kv_seg.copy()
    q_seg[0, 5] = 7  # no key carries segment 7
    j_out, j_lse = jax_fwd(q, k, v, q_seg, kv_seg, 0, bq=16, m_blk=16)
    t_out, t_lse = port_fwd(q, k, v, q_seg, kv_seg, 0)
    assert (t_lse[0, 5] == -1e30).all() and (t_out[0, 5] == 0).all()
    np.testing.assert_allclose(t_out, j_out, rtol=0, atol=ATOL)
    np.testing.assert_allclose(t_lse, j_lse, rtol=0, atol=ATOL)


def test_simple_matches_plain_mha_packed():
    """``mha_packed_gqa_simple`` is a drop-in for ``mha_packed``, and the
    port's ``mha_packed`` matches the JAX one."""
    rng = np.random.default_rng(10)
    B, L, H, K, Dh = 2, 40, 6, 2, 8
    q = rng.normal(size=(B, L, H, Dh)).astype(np.float32)
    k = rng.normal(size=(B, L, K, Dh)).astype(np.float32)
    v = rng.normal(size=(B, L, K, Dh)).astype(np.float32)
    seg = segments(rng, B, L, 3)
    tq, tk, tv, tseg = (torch.from_numpy(x) for x in (q, k, v, seg))
    simple = tgqa.mha_packed_gqa_simple(tq, tk, tv, tseg)
    plain = t_mha_packed(tq, tk, tv, tseg)
    np.testing.assert_allclose(simple.numpy(), plain.numpy(), rtol=0, atol=ATOL)
    ref = j_mha_packed(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(seg), jnp.asarray(seg))
    np.testing.assert_allclose(plain.numpy(), np.asarray(ref), rtol=0, atol=ATOL)


# --- backward: the port's plain backward and autograd function against the
# --- Pallas backward kernels (interpret mode) through the JAX custom VJP

BWD_TOL = dict(rtol=1e-4, atol=1e-4)  # fp32 both sides; sums in another order


def bwd_case(B, Lq, Lkv, H, K, Dh, n_segs, q_offset, masked_row=None, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Lq, H, Dh)).astype(np.float32)
    k = rng.normal(size=(B, Lkv, K, Dh)).astype(np.float32)
    v = rng.normal(size=(B, Lkv, K, Dh)).astype(np.float32)
    do = rng.normal(size=(B, Lq, H, Dh)).astype(np.float32)
    kv_seg = segments(rng, B, Lkv, n_segs)
    q_seg = kv_seg[:, q_offset : q_offset + Lq].copy()
    if masked_row is not None:
        q_seg[0, masked_row] = 99  # no key carries segment 99
    return q, k, v, q_seg, kv_seg, q_offset, do


def jax_grads(q, k, v, q_seg, kv_seg, q_offset, do, bq=16, m_blk=32):
    """dq, dk, dv of the JAX custom VJP (forward and both Pallas backward
    kernels)."""
    import jax

    B, Lq, H, Dh = q.shape
    K = k.shape[2]

    def f(q5, k_, v_):
        return jgqa._gqa_attention(q5, k_, v_, jnp.asarray(q_seg), jnp.asarray(kv_seg), q_offset, Dh**-0.5, bq, m_blk)

    _, vjp = jax.vjp(f, jnp.asarray(q.reshape(B, Lq, K, H // K, Dh)), jnp.asarray(k), jnp.asarray(v))
    dq, dk, dv = vjp(jnp.asarray(do.reshape(B, Lq, K, H // K, Dh)))
    return np.asarray(dq).reshape(q.shape), np.asarray(dk), np.asarray(dv)


BWD_CASES = [
    (1, 64, 64, 7, 1, 16, 3, 0, None),  # G = 7, the production fold
    (2, 64, 64, 4, 2, 8, 3, 0, None),  # batch 2, several segments
    (1, 32, 96, 4, 2, 8, 2, 64, None),  # q_offset > 0 with Lq < Lkv
    (1, 32, 32, 4, 2, 8, 1, 0, 5),  # a fully masked query row
]


@pytest.mark.parametrize("B,Lq,Lkv,H,K,Dh,n_segs,q_offset,masked_row", BWD_CASES)
def test_plain_backward_matches_pallas(B, Lq, Lkv, H, K, Dh, n_segs, q_offset, masked_row):
    q, k, v, q_seg, kv_seg, q_offset, do = bwd_case(B, Lq, Lkv, H, K, Dh, n_segs, q_offset, masked_row)
    t = [torch.from_numpy(x) for x in (q, k, v, q_seg, kv_seg)]
    out, lse = tgqa.mha_packed_gqa_plain(*t, q_offset, Dh**-0.5)
    grads = tgqa.mha_packed_gqa_bwd_plain(*t, q_offset, Dh**-0.5, out, lse, torch.from_numpy(do))
    for got, ref in zip(grads, jax_grads(q, k, v, q_seg, kv_seg, q_offset, do)):
        assert np.isfinite(got.numpy()).all()
        np.testing.assert_allclose(got.numpy(), ref, **BWD_TOL)


@pytest.mark.parametrize("B,Lq,Lkv,H,K,Dh,n_segs,q_offset,masked_row", BWD_CASES)
def test_autograd_function_matches_jax_grad(B, Lq, Lkv, H, K, Dh, n_segs, q_offset, masked_row):
    """``mha_packed_gqa`` under torch.autograd on the CPU (the plain forward
    and backward of the autograd function) against jax.vjp of the JAX op."""
    q, k, v, q_seg, kv_seg, q_offset, do = bwd_case(B, Lq, Lkv, H, K, Dh, n_segs, q_offset, masked_row, seed=1)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out, _ = tgqa.mha_packed_gqa(*leaves, torch.from_numpy(q_seg), torch.from_numpy(kv_seg), q_offset)
    out.backward(torch.from_numpy(do))
    for leaf, ref in zip(leaves, jax_grads(q, k, v, q_seg, kv_seg, q_offset, do)):
        np.testing.assert_allclose(leaf.grad.numpy(), ref, **BWD_TOL)


def test_grads_match_jax_xla_attention():
    """Mirrors tests/test_gqa_attention.py::test_grads_match_xla: gradients of
    sum(out^2) through the port's ``mha_packed_gqa_simple`` against jax.grad
    through the JAX package's XLA ``mha_packed``."""
    import jax

    rng = np.random.default_rng(3)
    B, L, H, K, Dh = 1, 128, 6, 2, 16
    q, k, v = (rng.normal(size=(B, L, n, Dh)).astype(np.float32) for n in (H, K, K))
    seg = segments(rng, B, L, 2)

    def loss_ref(q_, k_, v_):
        return jnp.sum(j_mha_packed(q_, k_, v_, jnp.asarray(seg), jnp.asarray(seg)) ** 2)

    refs = jax.grad(loss_ref, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    (tgqa.mha_packed_gqa_simple(*leaves, torch.from_numpy(seg)) ** 2).sum().backward()
    for leaf, ref in zip(leaves, refs):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(ref), **BWD_TOL)


def test_q_offset_shard_matches_full_in_grads():
    """Mirrors tests/test_gqa_attention.py::test_q_offset_matches_full: a
    query shard at q_offset gives the full computation's rows, and its
    gradients equal the full computation's for a loss on those rows."""
    rng = np.random.default_rng(4)
    B, L, H, K, Dh, lo = 1, 64, 4, 2, 8, 32
    q, k, v = (rng.normal(size=(B, L, n, Dh)).astype(np.float32) for n in (H, K, K))
    seg = torch.from_numpy(segments(rng, B, L, 2))

    full = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out_full, _ = tgqa.mha_packed_gqa(*full, seg, seg, 0)
    (out_full[:, lo:] ** 2).sum().backward()
    shard = [torch.from_numpy(q[:, lo:].copy()).requires_grad_()] + [torch.from_numpy(x).requires_grad_() for x in (k, v)]
    out_shard, _ = tgqa.mha_packed_gqa(*shard, seg[:, lo:].contiguous(), seg, lo)
    (out_shard**2).sum().backward()
    np.testing.assert_allclose(out_shard.detach().numpy(), out_full[:, lo:].detach().numpy(), **BWD_TOL)
    np.testing.assert_allclose(shard[0].grad.numpy(), full[0].grad[:, lo:].numpy(), **BWD_TOL)
    for a, b in zip(shard[1:], full[1:]):
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), **BWD_TOL)


@pytest.mark.parametrize("B,Lq,Lkv,H,K,Dh,n_segs,q_offset,masked_row", BWD_CASES)
@pytest.mark.parametrize("block", [16, 24])
def test_blocked_plain_versions_match_pallas(B, Lq, Lkv, H, K, Dh, n_segs, q_offset, masked_row, block):
    """The plain forward and backward by blocks of queries (how the card
    checks rows whose whole score matrix would not fit) against the Pallas
    forward and backward: blocks that divide the row and one that leaves a
    ragged last block, a q_offset row and a fully masked query row."""
    q, k, v, q_seg, kv_seg, q_offset, do = bwd_case(B, Lq, Lkv, H, K, Dh, n_segs, q_offset, masked_row, seed=2)
    t = [torch.from_numpy(x) for x in (q, k, v, q_seg, kv_seg)]
    out, lse = tgqa.mha_packed_gqa_plain_blocked(*t, q_offset, Dh**-0.5, block=block)
    j_out, j_lse = jax_fwd(q, k, v, q_seg, kv_seg, q_offset, 16, 32)
    np.testing.assert_allclose(out.numpy(), j_out, rtol=0, atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), j_lse, rtol=0, atol=ATOL)
    grads = tgqa.mha_packed_gqa_bwd_plain_blocked(*t, q_offset, Dh**-0.5, out, lse, torch.from_numpy(do), block=block)
    for got, ref in zip(grads, jax_grads(q, k, v, q_seg, kv_seg, q_offset, do)):
        np.testing.assert_allclose(got.numpy(), ref, **BWD_TOL)
