"""The port's staged decode attention against the JAX package's: the plain
XLA path in fp32, and the ragged kernel's plain version against the Pallas
kernel (interpret mode off TPU), both with bf16 operands. Also the CUDA
kernel's split plan, and a plain model of its split-and-merge arithmetic
held against the plain version and the Pallas kernel."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from pipelinerl_tpu.ops.attention import decode_attention_staged as j_staged
from pipelinerl_tpu.ops.decode_attention import decode_attention_staged_ragged as j_ragged
from pipelinerl_tpu_torch.ops import decode_attention as dattn
from pipelinerl_tpu_torch.ops.attention import decode_attention_staged as t_staged

torch.set_num_threads(1)
BF16_ATOL = 1e-2  # both sides round operands and P to bf16 at the same places


def make_inputs(seed, S, T, K, G, Dh, W):
    rng = np.random.default_rng(seed)
    H = K * G
    mk = lambda *s: rng.normal(size=s).astype(np.float32)
    return [mk(S, H, Dh), mk(S, K, Dh), mk(S, K, Dh), mk(S, T, K, Dh), mk(S, T, K, Dh),
            mk(W, S, K, Dh), mk(W, S, K, Dh)]


def run_both(j_fn, t_fn, a, lens, step):
    q, kn, vn, kc, vc, ks, vs = a
    lens = np.asarray(lens, np.int32)
    j_out = j_fn(*(jnp.asarray(x) for x in (q, kn, vn, kc, vc)), jnp.asarray(lens),
                 jnp.asarray(ks), jnp.asarray(vs), jnp.asarray(step))
    t_out = t_fn(*(torch.from_numpy(x) for x in (q, kn, vn, kc, vc)), torch.from_numpy(lens),
                 torch.from_numpy(ks), torch.from_numpy(vs), step)
    return t_out.numpy(), np.asarray(j_out)


CASES = [
    (step, lens) for step in (0, 3)
    for lens in ([0, 1, 5, 17], [17, 17, 17, 17], [0, 0, 0, 0])
]


@pytest.mark.parametrize("step,lens", CASES)
def test_ragged_plain_matches_pallas(step, lens):
    a = make_inputs(0, S=4, T=17, K=2, G=3, Dh=8, W=4)
    t_out, j_out = run_both(j_ragged, dattn.decode_attention_staged_ragged_plain, a, lens, step)
    np.testing.assert_allclose(t_out, j_out, rtol=0, atol=BF16_ATOL)


@pytest.mark.parametrize("step,lens", CASES)
def test_xla_path_matches_jax_fp32(step, lens):
    a = make_inputs(0, S=4, T=17, K=2, G=3, Dh=8, W=4)
    t_out, j_out = run_both(j_staged, t_staged, a, lens, step)
    np.testing.assert_allclose(t_out, j_out, rtol=1e-5, atol=1e-5)


def test_ragged_plain_multi_block_lengths():
    # T spanning several 128-row blocks with very different slot lengths
    a = make_inputs(1, S=3, T=300, K=2, G=2, Dh=16, W=8)
    t_out, j_out = run_both(j_ragged, dattn.decode_attention_staged_ragged_plain, a, [1, 130, 299], 5)
    np.testing.assert_allclose(t_out, j_out, rtol=0, atol=BF16_ATOL)


def test_wrapper_sends_cpu_tensors_to_the_plain_version():
    a = [torch.from_numpy(x) for x in make_inputs(2, S=4, T=17, K=2, G=3, Dh=8, W=4)]
    q, kn, vn, kc, vc, ks, vs = a
    lens = torch.tensor([0, 3, 9, 17], dtype=torch.int32)
    before = dattn.launches
    out = dattn.decode_attention_staged_ragged(q, kn, vn, kc, vc, lens, ks, vs, 2)
    ref = dattn.decode_attention_staged_ragged_plain(q, kn, vn, kc, vc, lens, ks, vs, 2)
    assert dattn.launches == before
    assert torch.equal(out, ref)
    # and the plain version agrees with the fp32 XLA path to bf16 precision
    xla = t_staged(q, kn, vn, kc, vc, lens, ks, vs, 2)
    np.testing.assert_allclose(out.numpy(), xla.numpy(), rtol=0, atol=0.05)


@pytest.mark.parametrize("T,splits", [(0, 1), (72, 1), (256, 1), (257, 2), (344, 2), (600, 3)])
def test_split_plan(T, splits):
    # T 344: the slab engine's T_alloc; T 72: the bandit_tpu engine's
    assert dattn.SPLIT_ROWS == 256
    assert dattn.split_plan(T) == splits


def split_merge_model(q, k_new, v_new, k_cache, v_cache, lens, k_staged, v_staged, step,
                      split_rows=dattn.SPLIT_ROWS, tile=64):
    """The CUDA kernel's arithmetic, one (slot, kv head) at a time: cache rows
    < min(len, T) in chunks of ``split_rows``, the band-plus-self tile in
    chunk ``min(len // split_rows, splits - 1)``; each chunk an online
    softmax over ``tile``-row tiles with P rounded to bf16 against the
    chunk's running max; the chunks' (m, l, acc) merged in fp32 in order.
    (The kernel also splits each tile over 4 warps and merges them the same
    way; that changes only where P is rounded.)"""
    S, H, Dh = q.shape
    T, K = k_cache.shape[1], k_cache.shape[2]
    G = H // K
    bf = torch.bfloat16
    qh = (q.float() * Dh**-0.5).to(bf).float().reshape(S, K, G, Dh)
    kc, vc = k_cache.to(bf).float(), v_cache.to(bf).float()
    band_k = torch.cat([k_staged[:step].transpose(0, 1), k_new[:, None]], 1).to(bf).float()
    band_v = torch.cat([v_staged[:step].transpose(0, 1), v_new[:, None]], 1).to(bf).float()
    splits = max(1, -(-T // split_rows))
    out = torch.empty(S, K, G, Dh)
    for s in range(S):
        length = min(max(int(lens[s]), 0), T)
        last = min(length // split_rows, splits - 1)
        for kh in range(K):
            parts = []
            for j in range(last + 1):
                lo, hi = j * split_rows, min(length, (j + 1) * split_rows)
                tiles = [(kc[s, t:min(t + tile, hi), kh], vc[s, t:min(t + tile, hi), kh]) for t in range(lo, hi, tile)]
                if j == last:
                    tiles.append((band_k[s, :, kh], band_v[s, :, kh]))
                m, l, acc = torch.full((G,), -1e30), torch.zeros(G), torch.zeros(G, Dh)
                for kt, vt in tiles:
                    scores = qh[s, kh] @ kt.T
                    m_new = torch.maximum(m, scores.amax(-1))
                    corr = torch.exp(m - m_new)
                    p = torch.exp(scores - m_new[:, None])
                    l = l * corr + p.sum(-1)
                    acc = acc * corr[:, None] + p.to(bf).float() @ vt
                    m = m_new
                parts.append((m, l, acc))
            mx = torch.stack([m for m, _, _ in parts]).amax(0)
            e = [torch.exp(m - mx) for m, _, _ in parts]
            total_l = sum(ej * l for ej, (_, l, _) in zip(e, parts))
            total = sum(ej[:, None] * acc for ej, (_, _, acc) in zip(e, parts))
            out[s, kh] = total / total_l[:, None]
    return out.reshape(S, H, Dh)


# lengths on the split edges of a 600-row cache: 0, C - 1, C, C + 1, 2C + 1
# and the longest the shape allows; and with 64-row chunks of 16-row tiles
SPLIT_CASES = [
    (step, split_rows, tile) for step in (0, 3) for split_rows, tile in ((256, 64), (64, 16))
]


@pytest.mark.parametrize("step,split_rows,tile", SPLIT_CASES)
def test_split_merge_model_matches_plain_and_pallas(step, split_rows, tile):
    C = split_rows
    lens = [0, C - 1, C, C + 1, 2 * C + 1, 600]
    a = make_inputs(3, S=len(lens), T=600, K=2, G=3, Dh=8, W=4)
    t = [torch.from_numpy(x) for x in a]
    lens_t = torch.tensor(lens, dtype=torch.int32)
    model = split_merge_model(*t[:5], lens_t, t[5], t[6], step, split_rows=C, tile=tile)
    plain = dattn.decode_attention_staged_ragged_plain(*t[:5], lens_t, t[5], t[6], step)
    # P is rounded against each chunk's running max, not the row's max
    np.testing.assert_allclose(model.numpy(), plain.numpy(), rtol=0, atol=BF16_ATOL)
    _, j_out = run_both(j_ragged, dattn.decode_attention_staged_ragged_plain, a, lens, step)
    np.testing.assert_allclose(model.numpy(), j_out, rtol=0, atol=BF16_ATOL)
