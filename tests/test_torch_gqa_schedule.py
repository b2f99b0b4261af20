"""The GQA kernels' tile schedule (``bwd_tile_spans_plain``, the plain
version of what kernels #2, #3 and #4 compute on the card) against the mask
of the port's plain attention; a forward summed tile by tile over that
schedule, split as kernel #2 splits it, against the JAX package's Pallas
forward in interpret mode; and a backward summed the same way, split as the
dk/dv kernel splits it, against the Pallas backward."""

import itertools
import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import pipelinerl_tpu.ops.gqa_attention as jgqa
from pipelinerl_tpu_torch.ops import gqa_attention as tgqa

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _interpret():
    jgqa.INTERPRET = True
    yield
    jgqa.INTERPRET = False


def packed_ids(lengths):
    return np.repeat(np.arange(len(lengths)), lengths)


def unsorted_ids(L, seed):
    """Segments in shuffled order, and one position in eight given a random id."""
    rng = np.random.default_rng(seed)
    ids = np.repeat(rng.permutation(5), rng.multinomial(L - 5 * 8, np.ones(5) / 5) + 8)
    stray = rng.choice(L, L // 8, replace=False)
    ids[stray] = rng.integers(0, 5, stray.size)
    return ids


# (B, Lq, Lkv, G, Dh, kv ids of one row, q_offset, a fully masked query row)
CASES = {
    "training layout, G 7": (1, 256, 256, 7, 64, packed_ids([32] * 8), 0, None),
    "unsorted ids": (2, 256, 256, 3, 64, unsorted_ids(256, 1), 0, None),
    "q_offset > 0, Lq < Lkv": (1, 96, 320, 4, 64, packed_ids([100, 150, 70]), 224, None),
    "ragged Lq G": (1, 100, 100, 3, 64, packed_ids([37, 63]), 0, None),
    "Dh 128, 32-row q tiles": (1, 150, 150, 2, 128, packed_ids([70, 80]), 0, None),
    "a fully masked row": (1, 128, 128, 5, 64, packed_ids([64, 64]), 0, 77),
}


def segment_ids(B, Lq, Lkv, ids, q_offset, masked_row):
    kv_seg = np.broadcast_to(ids.astype(np.int32), (B, Lkv)).copy()
    q_seg = kv_seg[:, q_offset : q_offset + Lq].copy()
    if masked_row is not None:
        q_seg[0, masked_row] = 99  # no key carries it
    return torch.from_numpy(q_seg), torch.from_numpy(kv_seg)


@pytest.mark.parametrize("case", list(CASES))
def test_schedule_covers_every_visible_pair(case):
    """Every visible (query, key) pair of ``_mask``, for every folded row of
    the query, lies in dq's span for the row's 64-row tile and in dk/dv's
    span for the key's tile; for any split count, the splits of a key
    tile's span partition it and exactly one holds the pair."""
    B, Lq, Lkv, G, Dh, ids, q_offset, masked_row = CASES[case]
    q_seg, kv_seg = segment_ids(B, Lq, Lkv, ids, q_offset, masked_row)
    QR = tgqa.dkv_q_rows(Dh)
    dq_spans, dkv_spans = (x.numpy() for x in tgqa.bwd_tile_spans_plain(q_seg, kv_seg, q_offset, G, Dh))
    assert dq_spans.shape == (B, -(-Lq * G // tgqa.TILE), 2) and dkv_spans.shape == (B, -(-Lkv // tgqa.TILE), 2)

    b, i, j = np.nonzero(tgqa._mask(q_seg, kv_seg, q_offset)[:, 0, 0].numpy())
    assert b.size > 0
    rows = (i[:, None] * G + np.arange(G)).ravel()
    b, j = np.repeat(b, G), np.repeat(j, G)
    dq = dq_spans[b, rows // tgqa.TILE]
    assert ((dq[:, 0] <= j // tgqa.TILE) & (j // tgqa.TILE <= dq[:, 1])).all()
    dkv, t = dkv_spans[b, j // tgqa.TILE], rows // QR
    assert ((dkv[:, 0] <= t) & (t <= dkv[:, 1])).all()

    S_shape = tgqa.dkv_splits(B, Lq, Lkv, 1, G, Dh)
    for S in sorted({1, 2, 3, S_shape, tgqa.MAX_SPLITS}):
        holders = np.zeros(t.size, np.int64)
        for first, last in dkv_spans.reshape(-1, 2).tolist():
            parts = [tgqa.rank_share(first, last, S, r) for r in range(S)]
            assert parts[0][0] == first and parts[-1][1] == max(first, last + 1)
            assert all(a[1] == c[0] and a[0] <= a[1] for a, c in zip(parts, parts[1:]))
        for r in range(S):
            begin, end = np.array([tgqa.rank_share(f, l, S, r) for f, l in dkv.tolist()]).T
            holders += (begin <= t) & (t < end)
        assert (holders == 1).all()
    if masked_row is not None:  # the row sees no key: its tile's span may still hold the rest
        assert not tgqa._mask(q_seg, kv_seg, q_offset)[0, 0, 0, masked_row].any()


def test_schedule_is_tight_on_packed_rows():
    """On the packer's layout (sorted ids, q_offset 0) every span is exactly
    the range of tiles that hold a visible pair of it: the kernels visit no
    tile outside the hull of the work."""
    for G, Dh, lengths in ((7, 64, [32] * 8), (2, 128, [70, 50, 136]), (4, 64, [256])):
        L = sum(lengths)
        q_seg, kv_seg = segment_ids(1, L, L, packed_ids(lengths), 0, None)
        QR = tgqa.dkv_q_rows(Dh)
        dq_spans, dkv_spans = (x.numpy()[0] for x in tgqa.bwd_tile_spans_plain(q_seg, kv_seg, 0, G, Dh))
        _, i, j = np.nonzero(tgqa._mask(q_seg, kv_seg, 0)[:, 0, 0].numpy())
        rows = (i[:, None] * G + np.arange(G)).ravel()
        j = np.repeat(j, G)
        for spans, tile, other in ((dq_spans, rows // tgqa.TILE, j // tgqa.TILE), (dkv_spans, j // tgqa.TILE, rows // QR)):
            for x, (first, last) in enumerate(spans.tolist()):
                held = other[tile == x]
                assert (first, last) == ((held.min(), held.max()) if held.size else (0, -1))


def scheduled_backward(q, k, v, q_seg, kv_seg, q_offset, scale, do, splits):
    """dq, dk, dv summed tile by tile over the schedule in fp32: dq over
    each 64-row q tile's key span, dk/dv over each key tile's q span in
    ``splits`` parts whose partials are added in part order, as the card's
    kernels sum them."""
    B, Lq, H, Dh = q.shape
    Lkv, K = k.shape[1], k.shape[2]
    G, QR, T = H // K, tgqa.dkv_q_rows(Dh), tgqa.TILE
    out, lse = tgqa.mha_packed_gqa_plain(q, k, v, q_seg, kv_seg, q_offset, scale)
    delta = tgqa._delta(out, do, K)
    dq_spans, dkv_spans = tgqa.bwd_tile_spans_plain(q_seg, kv_seg, q_offset, G, Dh)
    mask = tgqa._mask(q_seg, kv_seg, q_offset)[:, 0, 0]  # [B, Lq, Lkv]
    dq, dk, dv = torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    for b in range(B):
        for kh in range(K):
            # folded rows r = i * G + g
            qf = q[b, :, kh * G : (kh + 1) * G].reshape(Lq * G, Dh)
            dof = do[b, :, kh * G : (kh + 1) * G].reshape(Lq * G, Dh)
            lse_f, delta_f = lse[b, :, kh].reshape(-1), delta[b, :, kh].reshape(-1)
            mask_f = mask[b].repeat_interleave(G, 0)  # [Lq * G, Lkv]

            def grads(r0, r1, j0, j1):
                s = qf[r0:r1] @ k[b, j0:j1, kh].T * scale
                p = torch.where(mask_f[r0:r1, j0:j1], torch.exp(s - lse_f[r0:r1, None]), torch.zeros_like(s))
                ds = p * (dof[r0:r1] @ v[b, j0:j1, kh].T - delta_f[r0:r1, None])
                return p, ds

            dqf = torch.zeros(Lq * G, Dh)
            for t, (first, last) in enumerate(dq_spans[b].tolist()):
                r0, r1 = t * T, min((t + 1) * T, Lq * G)
                for jt in range(first, last + 1):
                    _, ds = grads(r0, r1, jt * T, min((jt + 1) * T, Lkv))
                    dqf[r0:r1] += ds @ k[b, jt * T : (jt + 1) * T, kh]
            dq[b, :, kh * G : (kh + 1) * G] = (dqf * scale).reshape(Lq, G, Dh)
            for jt, (first, last) in enumerate(dkv_spans[b].tolist()):
                j0, j1 = jt * T, min((jt + 1) * T, Lkv)
                parts = []
                for r in range(splits):
                    pk, pv = torch.zeros(j1 - j0, Dh), torch.zeros(j1 - j0, Dh)
                    for t in range(*tgqa.rank_share(first, last, splits, r)):
                        r0, r1 = t * QR, min((t + 1) * QR, Lq * G)
                        p, ds = grads(r0, r1, j0, j1)
                        pv += p.T @ dof[r0:r1]
                        pk += ds.T @ qf[r0:r1]
                    parts.append((pk, pv))
                dk[b, j0:j1, kh] = sum(x for x, _ in parts) * scale
                dv[b, j0:j1, kh] = sum(y for _, y in parts)
    return dq, dk, dv


def backward_inputs(case):
    """fp32 inputs at ``case``'s layout and head width, two kv heads."""
    B, Lq, Lkv, G, Dh, ids, q_offset, masked_row = CASES[case]
    K = 2
    q_seg, kv_seg = segment_ids(B, Lq, Lkv, ids, q_offset, masked_row)
    rng = np.random.default_rng(7)
    q = rng.normal(size=(B, Lq, K * G, Dh)).astype(np.float32)
    k, v = (rng.normal(size=(B, Lkv, K, Dh)).astype(np.float32) for _ in range(2))
    do = rng.normal(size=q.shape).astype(np.float32)
    return q, k, v, q_seg, kv_seg, q_offset, do


def jax_grads(q, k, v, q_seg, kv_seg, q_offset, do):
    B, Lq, H, Dh = q.shape
    K = k.shape[2]

    def f(q5, k_, v_):
        return jgqa._gqa_attention(q5, k_, v_, jnp.asarray(q_seg.numpy()), jnp.asarray(kv_seg.numpy()), q_offset,
                                   Dh**-0.5, 16, 32)

    _, vjp = jax.vjp(f, jnp.asarray(q.reshape(B, Lq, K, H // K, Dh)), jnp.asarray(k), jnp.asarray(v))
    dq, dk, dv = vjp(jnp.asarray(do.reshape(B, Lq, K, H // K, Dh)))
    return np.asarray(dq).reshape(q.shape), np.asarray(dk), np.asarray(dv)


@pytest.mark.parametrize("case", ["training layout, G 7", "unsorted ids", "q_offset > 0, Lq < Lkv", "a fully masked row"])
def test_scheduled_backward_matches_pallas(case):
    """The backward summed over the schedule, dk/dv split in three, equals
    the JAX custom VJP (forward and both Pallas backward kernels) in fp32,
    on lengths that are multiples of the Pallas blocks (16 and 32 here)."""
    q, k, v, q_seg, kv_seg, q_offset, do = backward_inputs(case)
    got = scheduled_backward(*(torch.from_numpy(x) for x in (q, k, v)), q_seg, kv_seg, q_offset,
                             q.shape[-1] ** -0.5, torch.from_numpy(do), splits=3)
    ref = jax_grads(q, k, v, q_seg, kv_seg, q_offset, do)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("case", ["ragged Lq G", "Dh 128, 32-row q tiles"])
def test_scheduled_backward_matches_plain(case):
    """On lengths that are not multiples of the Pallas blocks (the JAX
    package's entry point then falls back to a plain-JAX kernel), the
    backward summed over the schedule (split in three) equals the port's
    plain backward, which the tests of ops/gqa_attention hold to JAX."""
    q, k, v, q_seg, kv_seg, q_offset, do = backward_inputs(case)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    scale = q.shape[-1] ** -0.5
    got = scheduled_backward(tq, tk, tv, q_seg, kv_seg, q_offset, scale, tdo, splits=3)
    out, lse = tgqa.mha_packed_gqa_plain(tq, tk, tv, q_seg, kv_seg, q_offset, scale)
    for g, r in zip(got, tgqa.mha_packed_gqa_bwd_plain(tq, tk, tv, q_seg, kv_seg, q_offset, scale, out, lse, tdo)):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-4, atol=1e-4)


def scheduled_forward(q, k, v, q_seg, kv_seg, q_offset, scale, splits):
    """out and lse summed tile by tile over the schedule in fp32, as kernel
    #2 sums them: each 64-row q tile's key span (dq's) in ``splits`` rank
    shares, scores in log2 units through exp2, a tile holding no key of the
    rows' id range skipped and a ``full`` tile run unmasked (the mask is
    asserted to hold on all of it), then the ranks' (m, l, O) partials
    merged in rank order."""
    B, Lq, H, Dh = q.shape
    Lkv, K = k.shape[1], k.shape[2]
    G, T, neg = H // K, tgqa.TILE, tgqa._NEG_INF
    n_rows = Lq * G
    scale2 = scale * math.log2(math.e)
    dq_spans, _ = tgqa.bwd_tile_spans_plain(q_seg, kv_seg, q_offset, G, Dh)
    mask = tgqa._mask(q_seg, kv_seg, q_offset)[:, 0, 0]  # [B, Lq, Lkv]
    out, lse = torch.zeros_like(q), torch.zeros(B, Lq, K, G)
    for b in range(B):
        for kh in range(K):
            qf = q[b, :, kh * G : (kh + 1) * G].reshape(n_rows, Dh)  # folded rows r = i * G + g
            mask_f = mask[b].repeat_interleave(G, 0)
            of, lf = torch.zeros(n_rows, Dh), torch.zeros(n_rows)
            for t, (first, last) in enumerate(dq_spans[b].tolist()):
                r0, r1 = t * T, min((t + 1) * T, n_rows)
                ids = q_seg[b, r0 // G : (r1 - 1) // G + 1]
                q_mn, q_mx = int(ids.min()), int(ids.max())
                parts = []
                for rank in range(splits):
                    m, l, o = torch.full((r1 - r0,), neg), torch.zeros(r1 - r0), torch.zeros(r1 - r0, Dh)
                    for jt in range(*tgqa.rank_share(first, last, splits, rank)):
                        j0, j1 = jt * T, min((jt + 1) * T, Lkv)
                        vis = mask_f[r0:r1, j0:j1]
                        hits = int(((kv_seg[b, j0:j1] >= q_mn) & (kv_seg[b, j0:j1] <= q_mx)).sum())
                        if hits == 0:
                            assert not vis.any()
                            continue
                        x = qf[r0:r1] @ k[b, j0:j1, kh].T * scale2
                        if hits == T and q_mn == q_mx and j0 + T - 1 <= q_offset + r0 // G:
                            assert vis.all()  # the kernel runs this tile unmasked
                        else:
                            x = torch.where(vis, x, torch.full_like(x, neg))
                        m_new = torch.maximum(m, x.amax(1))
                        m_safe = m_new.clamp(min=-1e29)
                        p = torch.exp2(x - m_safe[:, None])
                        corr = torch.exp2(m - m_safe)
                        l = l * corr + p.sum(1)
                        o = o * corr[:, None] + p.to(v.dtype).float() @ v[b, j0:j1, kh].float()
                        m = m_new
                    parts.append((m, l, o))
                mx = torch.stack([pm for pm, _, _ in parts]).amax(0)
                m_safe = mx.clamp(min=-1e29)
                l, o = torch.zeros(r1 - r0), torch.zeros(r1 - r0, Dh)
                for pm, pl, po in parts:  # rank order
                    w = torch.exp2(pm - m_safe)
                    l, o = l + w * pl, o + w[:, None] * po
                l = l.clamp(min=1e-30)
                of[r0:r1] = o / l[:, None]
                lf[r0:r1] = torch.where(mx > 0.5 * neg, (mx + torch.log2(l)) * math.log(2), torch.full_like(mx, neg))
            out[b, :, kh * G : (kh + 1) * G] = of.reshape(Lq, G, Dh)
            lse[b, :, kh] = lf.reshape(Lq, G)
    return out, lse


def _divisor(n, candidates):
    return next(c for c in candidates if n % c == 0)


def jax_forward(q, k, v, q_seg, kv_seg, q_offset):
    """The Pallas forward (``_fwd_call``) in interpret mode, with blocks that
    divide the lengths: out [B, Lq, H, Dh] and lse in the port's [B, Lq, K,
    G]."""
    B, Lq, H, Dh = q.shape
    K = k.shape[2]
    bq, m_blk = _divisor(Lq, (16, 10, 5, 4, 2, 1)), _divisor(k.shape[1], (32, 50, 25, 20, 10, 5, 1))
    out, lse = jgqa._fwd_call(jnp.asarray(q.reshape(B, Lq, K, H // K, Dh)), jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(q_seg.numpy()), jnp.asarray(kv_seg.numpy()), q_offset, Dh**-0.5, bq, m_blk)
    return np.asarray(out).reshape(q.shape), np.asarray(lse).transpose(0, 3, 1, 2)  # from [B, K, G, Lq]


@pytest.mark.parametrize("case", list(CASES))
def test_scheduled_forward_matches_pallas(case):
    """The forward summed over the schedule, split as ``fwd_splits`` splits
    the shape, in three and in ``MAX_SPLITS``, equals the JAX Pallas forward in fp32, out and
    lse, fully masked rows included (out 0, lse -1e30)."""
    q, k, v, q_seg, kv_seg, q_offset, _ = backward_inputs(case)
    B, Lq, H, Dh = q.shape
    Lkv, K = k.shape[1], k.shape[2]
    ref_out, ref_lse = jax_forward(q, k, v, q_seg, kv_seg, q_offset)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    for splits in sorted({tgqa.fwd_splits(B, Lq, Lkv, K, H // K, Dh), 3, tgqa.MAX_SPLITS}):
        out, lse = scheduled_forward(tq, tk, tv, q_seg, kv_seg, q_offset, Dh**-0.5, splits)
        np.testing.assert_allclose(out.numpy(), ref_out, rtol=0, atol=1e-4)
        np.testing.assert_allclose(lse.numpy(), ref_lse, rtol=0, atol=1e-4)
    masked_row = CASES[case][-1]
    if masked_row is not None:
        assert (lse[0, masked_row] == tgqa._NEG_INF).all() and (out[0, masked_row] == 0).all()


def test_fwd_splits():
    """As ops/sweep_gqa_attention_fwd.py read it on the card: 1 at the
    training row (896 blocks fill the card), at the prefill buckets (B 8 at
    L 128; B 1 at L 512, a mean span of 4 key tiles) and on B 8 extend
    tails (a second block per q tile would not fit one wave); 2 at the
    q_offset 384 row (8 tiles of mean span); on the paged engine's partial
    batches of extends (B 1, 2, 4 tails of 128 after page buckets of 8 and
    16) 4, 4, 3 and 8, 6, 3; 8 on a resumed turn (B 1, 128 queries after
    3,968 keys). Never more than ``MAX_SPLITS`` or the key tiles, and a
    split grid fits 7/8 of a wave of resident blocks."""
    assert tgqa.fwd_splits(1, 4096, 4096, 2, 7, 64) == 1
    assert tgqa.fwd_splits(2, 256, 640, 2, 7, 64) == 2
    assert tgqa.fwd_splits(8, 128, 128, 2, 7, 64) == tgqa.fwd_splits(1, 512, 512, 2, 7, 64) == 1
    assert tgqa.fwd_splits(8, 128, 640, 2, 7, 64) == tgqa.fwd_splits(8, 128, 2048, 2, 7, 64) == 1
    assert [tgqa.fwd_splits(B, 128, 1152, 2, 7, 64) for B in (1, 2, 4)] == [4, 4, 3]
    assert [tgqa.fwd_splits(B, 128, 2176, 2, 7, 64) for B in (1, 2, 4)] == [8, 6, 3]
    assert tgqa.fwd_splits(1, 128, 4096, 2, 7, 64) == 8
    wave = {Dh: blocks * tgqa.SM_COUNT * 7 // 8 for Dh, blocks in tgqa.FWD_BLOCKS_PER_SM.items()}
    for B, Lq, Lkv, K, G, Dh in itertools.product((1, 2, 8), (1, 32, 100, 128, 256, 4096), (64, 100, 640, 4096),
                                                  (1, 2), (1, 2, 7), (64, 128)):
        if Lq <= Lkv:
            S = tgqa.fwd_splits(B, Lq, Lkv, K, G, Dh)
            assert 1 <= S <= min(tgqa.MAX_SPLITS, -(-Lkv // tgqa.TILE))
            assert S == 1 or -(-(Lq * G) // tgqa.TILE) * B * K * S <= wave[Dh]
