"""The port's CUDA kernels against their plain versions, on the card.

Run on a machine with an NVIDIA Hopper GPU and nvcc, from the repo's root
(kernel #5's tables come from ``chip_smoke.scattered_table``, so that the
tests and the smoke script check one table layout):

    python -m pytest -m cuda tests/test_torch_cuda.py

Whether there is a card is decided in a fixture, so every worker collects
the same tests; without one they skip.
"""

import numpy as np
import pytest
import torch

from chip_smoke import OUT_ROW_RTOL, row_rel_err, scattered_table
from pipelinerl_tpu_torch.models.transformer import extend_segments
from pipelinerl_tpu_torch.ops import decode_attention as dattn
from pipelinerl_tpu_torch.ops import gqa_attention as gattn
from pipelinerl_tpu_torch.ops import paged_attention as pattn

pytestmark = pytest.mark.cuda

DECODE_ATOL = 2e-2  # fp32 out; both sides bf16 operands, bf16 P, fp32 sums
GQA_OUT_ATOL = 2e-2  # bf16 out over O(1) values
GQA_LSE_ATOL = 2e-3  # fp32 scores from bf16 operands, summed in another order


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _bf16(gen, *shape):
    return torch.randn(shape, generator=gen, device=gen.device).to(torch.bfloat16)


@pytest.mark.parametrize(
    "S,H,K,Dh,T,W,lens,step",
    [
        (4, 6, 2, 64, 40, 4, [0, 1, 17, 36], 0),
        (4, 6, 2, 64, 40, 4, [0, 1, 17, 36], 3),
        (3, 8, 1, 128, 300, 8, [130, 0, 292], 5),
        (64, 14, 2, 64, 344, 16, [0, 1, 37, 328] + [127 + i for i in range(60)], 15),
    ],
)
def test_decode_kernel_matches_plain(cuda, S, H, K, Dh, T, W, lens, step):
    gen = torch.Generator(device=cuda).manual_seed(0)
    args = (_bf16(gen, S, H, Dh), _bf16(gen, S, K, Dh), _bf16(gen, S, K, Dh),
            _bf16(gen, S, T, K, Dh), _bf16(gen, S, T, K, Dh),
            torch.tensor(lens, dtype=torch.int32, device=cuda),
            _bf16(gen, W, S, K, Dh), _bf16(gen, W, S, K, Dh), step)
    before = dattn.launches
    out = dattn.decode_attention_staged_ragged(*args)
    torch.cuda.synchronize()
    assert dattn.launches == before + 1
    ref = dattn.decode_attention_staged_ragged_plain(*args)
    assert (out.float() - ref.float()).abs().max().item() <= DECODE_ATOL


C = dattn.SPLIT_ROWS
SPLIT_EDGES = [0, C - 1, C, C + 1, 2 * C + 1]


@pytest.mark.parametrize(
    "S,H,K,Dh,T,W,lens,step",
    [
        # lengths on the split edges, the longest the shape allows (T), and
        # one past it (read as T, as the plain version does)
        (8, 14, 2, 64, 1024, 16, SPLIT_EDGES + [1024, 1030, 700], 0),
        (8, 14, 2, 64, 1024, 16, SPLIT_EDGES + [1024, 1030, 700], 15),
        (7, 8, 1, 128, 600, 8, SPLIT_EDGES + [600, 3], 5),
        (7, 4, 2, 32, 600, 4, SPLIT_EDGES + [600, 3], 2),
        # the slab engine's T_alloc: 2 splits
        (8, 14, 2, 64, 344, 16, [0, C - 1, C, C + 1, 328, 344, 100, 37], 15),
    ],
)
def test_decode_kernel_matches_plain_on_split_edges(cuda, S, H, K, Dh, T, W, lens, step):
    gen = torch.Generator(device=cuda).manual_seed(10)
    args = (_bf16(gen, S, H, Dh), _bf16(gen, S, K, Dh), _bf16(gen, S, K, Dh),
            _bf16(gen, S, T, K, Dh), _bf16(gen, S, T, K, Dh),
            torch.tensor(lens, dtype=torch.int32, device=cuda),
            _bf16(gen, W, S, K, Dh), _bf16(gen, W, S, K, Dh), step)
    before = dattn.launches
    out = dattn.decode_attention_staged_ragged(*args)
    torch.cuda.synchronize()
    assert dattn.launches == before + 1
    ref = dattn.decode_attention_staged_ragged_plain(*args)
    assert (out.float() - ref.float()).abs().max().item() <= DECODE_ATOL
    assert torch.equal(dattn.decode_attention_staged_ragged(*args), out)  # no atomics on the sums


def test_decode_kernel_reads_strided_layer_slices(cuda):
    """The engine hands the kernel per-layer slices of [L, S, T, K, Dh]."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    L, S, H, K, Dh, T, W = 3, 4, 4, 2, 64, 50, 4
    kc, vc = _bf16(gen, L, S, T, K, Dh), _bf16(gen, L, S, T, K, Dh)
    ks, vs = _bf16(gen, L, W, S, K, Dh), _bf16(gen, L, W, S, K, Dh)
    q, kn, vn = _bf16(gen, S, H, Dh), _bf16(gen, S, K, Dh), _bf16(gen, S, K, Dh)
    lens = torch.tensor([3, 0, 49, 20], dtype=torch.int32, device=cuda)
    out = dattn.decode_attention_staged_ragged(q, kn, vn, kc[1], vc[1], lens, ks[2], vs[2], 2)
    ref = dattn.decode_attention_staged_ragged_plain(q, kn, vn, kc[1], vc[1], lens, ks[2], vs[2], 2)
    assert (out.float() - ref.float()).abs().max().item() <= DECODE_ATOL


@pytest.mark.parametrize(
    "B,Lq,Lkv,H,K,Dh,n_segs",
    [
        (2, 100, 100, 6, 2, 64, 3),  # ragged edges
        (8, 128, 128, 14, 2, 64, 1),  # the prefill shape
        (1, 2048, 2048, 14, 2, 64, 8),  # a packed row
        (2, 96, 320, 8, 1, 128, 2),  # q_offset > 0, Lq < Lkv, Dh 128
        (8, 256, 256, 14, 2, 64, 1),  # the paged engine's prefill buckets
        (8, 512, 512, 14, 2, 64, 1),
    ],
)
def test_gqa_kernel_matches_plain(cuda, B, Lq, Lkv, H, K, Dh, n_segs):
    gen = torch.Generator(device=cuda).manual_seed(2)
    q, k, v = _bf16(gen, B, Lq, H, Dh), _bf16(gen, B, Lkv, K, Dh), _bf16(gen, B, Lkv, K, Dh)
    kv_seg = (torch.arange(Lkv, device=cuda) * n_segs // Lkv).to(torch.int32)[None].expand(B, Lkv).contiguous()
    q_seg = kv_seg[:, Lkv - Lq :].contiguous()
    before = gattn.launches
    out, lse = gattn.mha_packed_gqa(q, k, v, q_seg, kv_seg, Lkv - Lq)
    torch.cuda.synchronize()
    assert gattn.launches == before + 1
    ref_out, ref_lse = gattn.mha_packed_gqa_plain(q, k, v, q_seg, kv_seg, Lkv - Lq)
    assert (out.float() - ref_out.float()).abs().max().item() <= GQA_OUT_ATOL
    assert (lse - ref_lse).abs().max().item() <= GQA_LSE_ATOL


@pytest.mark.parametrize("Lt,prefix_lens", [(128, [384] * 8), (256, [384, 128, 512, 256, 384, 384, 512, 256])])
def test_gqa_kernel_matches_plain_on_extend_tails(cuda, Lt, prefix_lens):
    """Tails at q_offset = Pfx against [padded prefix | tail] as
    ``forward_extend`` lays them out: the prefix pad, segment 1, sits
    between the valid prefix and the tail, both segment 0."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    B, Pfx, H, K, Dh = len(prefix_lens), 512, 14, 2, 64
    q, k, v = _bf16(gen, B, Lt, H, Dh), _bf16(gen, B, Pfx + Lt, K, Dh), _bf16(gen, B, Pfx + Lt, K, Dh)
    q_seg, kv_seg = extend_segments(torch.tensor(prefix_lens, device=cuda), Pfx, Lt)
    out, lse = gattn.mha_packed_gqa(q, k, v, q_seg, kv_seg, Pfx)
    ref_out, ref_lse = gattn.mha_packed_gqa_plain(q, k, v, q_seg, kv_seg, Pfx)
    assert (out.float() - ref_out.float()).abs().max().item() <= GQA_OUT_ATOL
    assert (lse - ref_lse).abs().max().item() <= GQA_LSE_ATOL


def _gqa_fwd_inputs(gen, B, Lq, Lkv, H, K, Dh, ids, dev):
    """Kernel #2's inputs: ``ids`` (numpy) the segment id of each key, the
    queries the last Lq keys' positions (q_offset = Lkv - Lq)."""
    q, k, v = _bf16(gen, B, Lq, H, Dh), _bf16(gen, B, Lkv, K, Dh), _bf16(gen, B, Lkv, K, Dh)
    kv_seg = torch.from_numpy(ids.astype(np.int32))[None].expand(B, Lkv).contiguous().to(dev)
    return q, k, v, kv_seg[:, Lkv - Lq :].contiguous(), kv_seg, Lkv - Lq


def _check_fwd_kernel(args):
    """One launch of kernel #2 against its plain version, and a second call
    bit for bit equal to the first; returns (out, lse)."""
    before = gattn.launches
    out, lse = gattn.mha_packed_gqa(*args)
    torch.cuda.synchronize()
    assert gattn.launches == before + 1
    ref_out, ref_lse = gattn.mha_packed_gqa_plain(*args)
    assert (out.float() - ref_out.float()).abs().max().item() <= GQA_OUT_ATOL
    assert (lse - ref_lse).abs().max().item() <= GQA_LSE_ATOL
    again = gattn.mha_packed_gqa(*args)
    assert torch.equal(again[0], out) and torch.equal(again[1], lse)  # no atomics in the split merge
    return out, lse


@pytest.mark.parametrize("splits", range(1, gattn.MAX_SPLITS + 1))
@pytest.mark.parametrize("Dh,H,K", [(64, 14, 2), (128, 8, 1)])
def test_gqa_forward_on_split_edges(cuda, monkeypatch, splits, Dh, H, K):
    """Lq G and Lkv not multiples of 64 (201 queries at q_offset 576, 777
    keys in 3 segments), each q tile's key span split over every cluster
    size S from 1 to MAX_SPLITS (``fwd_splits`` overridden): ranks with
    empty shares and uneven ones."""
    monkeypatch.setattr(gattn, "fwd_splits", lambda *_: splits)
    ids = np.repeat(np.arange(3), [300, 260, 217])
    _check_fwd_kernel(_gqa_fwd_inputs(torch.Generator(device=cuda).manual_seed(15), 2, 201, 777, H, K, Dh, ids, cuda))


@pytest.mark.parametrize(
    "B,Lq,Lkv,H,K,Dh,layout",
    [
        (1, 4096, 4096, 14, 2, 64, "shuffled"),  # the training row's size, segments out of order
        (2, 256, 640, 14, 2, 64, "shuffled"),  # q_offset 384 with Lq < Lkv
        (2, 600, 600, 6, 2, 64, "random"),  # an id drawn at random for each position
        (1, 777, 777, 8, 1, 128, "shuffled"),  # Dh 128, ragged
    ],
)
def test_gqa_forward_on_unsorted_segment_ids(cuda, B, Lq, Lkv, H, K, Dh, layout):
    rng = np.random.default_rng(Lkv)
    if layout == "shuffled":
        ids = np.repeat(rng.permutation(8), rng.multinomial(Lkv - 8 * 16, np.ones(8) / 8) + 16)
    else:
        ids = rng.integers(0, 3, Lkv)
    _check_fwd_kernel(_gqa_fwd_inputs(torch.Generator(device=cuda).manual_seed(16), B, Lq, Lkv, H, K, Dh, ids, cuda))


@pytest.mark.parametrize("splits", [1, 4])
@pytest.mark.parametrize("Dh,H,K", [(64, 14, 2), (128, 8, 1)])
def test_gqa_forward_fully_masked_row(cuda, monkeypatch, splits, Dh, H, K):
    """A query whose segment has no key (q_offset 384), with one block per
    q tile and with four that merge: out 0 and lse -1e30."""
    monkeypatch.setattr(gattn, "fwd_splits", lambda *_: splits)
    args = list(_gqa_fwd_inputs(torch.Generator(device=cuda).manual_seed(17), 2, 256, 640, H, K, Dh,
                                np.repeat(np.arange(2), [400, 240]), cuda))
    args[3] = args[3].clone()
    args[3][1, 100] = 9  # no key carries it
    out, lse = _check_fwd_kernel(args)
    assert (lse[1, 100] == -1e30).all() and (out[1, 100] == 0).all()


def _gqa_bwd_inputs(gen, B, Lq, Lkv, H, K, Dh, n_segs, dev):
    q, k, v = _bf16(gen, B, Lq, H, Dh), _bf16(gen, B, Lkv, K, Dh), _bf16(gen, B, Lkv, K, Dh)
    kv_seg = (torch.arange(Lkv, device=dev) * n_segs // Lkv).to(torch.int32)[None].expand(B, Lkv).contiguous()
    q_seg = kv_seg[:, Lkv - Lq :].contiguous()
    out, lse = gattn.mha_packed_gqa_plain(q, k, v, q_seg, kv_seg, Lkv - Lq)
    return q, k, v, q_seg, kv_seg, Lkv - Lq, out.to(torch.bfloat16), lse, _bf16(gen, B, Lq, H, Dh)


def _close(got, ref):
    """bf16 outputs: 2^-8 relative rounding, plus a bf16 rounding of P or dS
    that can flip where fp32 sums differ in order; held to 1e-2 of the
    largest reference value."""
    return (got.float() - ref.float()).abs().max().item() <= 1e-2 * max(1.0, ref.float().abs().max().item())


@pytest.mark.parametrize(
    "B,Lq,Lkv,H,K,Dh,n_segs",
    [
        (2, 100, 100, 6, 2, 64, 3),  # ragged edges, batch 2
        (1, 2048, 2048, 14, 2, 64, 8),  # a packed training row
        (2, 96, 320, 8, 1, 128, 2),  # q_offset > 0, Lq < Lkv, Dh 128
        (8, 256, 256, 14, 2, 64, 1),  # the paged engine's prefill buckets
        (8, 512, 512, 14, 2, 64, 1),
    ],
)
def test_gqa_backward_kernels_match_plain(cuda, B, Lq, Lkv, H, K, Dh, n_segs):
    gen = torch.Generator(device=cuda).manual_seed(4)
    args = _gqa_bwd_inputs(gen, B, Lq, Lkv, H, K, Dh, n_segs, cuda)
    before = (gattn.dq_launches, gattn.dkv_launches)
    dq, dk, dv = gattn.mha_packed_gqa_bwd(*args[:5], args[5], Dh**-0.5, *args[6:])
    torch.cuda.synchronize()
    assert (gattn.dq_launches, gattn.dkv_launches) == (before[0] + 1, before[1] + 1)
    rq, rk, rv = gattn.mha_packed_gqa_bwd_plain(*args[:5], args[5], Dh**-0.5, *args[6:])
    assert _close(dq, rq) and _close(dk, rk) and _close(dv, rv)


def _segment_ids(lengths, B, dev):
    seg = torch.repeat_interleave(torch.arange(len(lengths), dtype=torch.int32), torch.tensor(lengths))
    return seg[None].expand(B, -1).contiguous().to(dev)


def _bwd_with_segments(gen, B, L, H, K, Dh, kv_seg, dev):
    """Kernel inputs at q_offset 0 over ``kv_seg``, out and lse from the plain
    forward."""
    q, k, v = _bf16(gen, B, L, H, Dh), _bf16(gen, B, L, K, Dh), _bf16(gen, B, L, K, Dh)
    out, lse = gattn.mha_packed_gqa_plain(q, k, v, kv_seg, kv_seg, 0)
    return q, k, v, kv_seg, kv_seg, 0, Dh**-0.5, out.to(torch.bfloat16), lse, _bf16(gen, B, L, H, Dh)


def _check_bwd_kernels(args):
    """One call of each wrapper (one launch each) against the plain backward,
    a second call bit for bit equal to the first, and the device's tile
    schedule equal to its plain version."""
    before = (gattn.dq_launches, gattn.dkv_launches)
    dq, dk, dv = gattn.mha_packed_gqa_bwd(*args)
    torch.cuda.synchronize()
    assert (gattn.dq_launches, gattn.dkv_launches) == (before[0] + 1, before[1] + 1)
    rq, rk, rv = gattn.mha_packed_gqa_bwd_plain(*args)
    assert _close(dq, rq) and _close(dk, rk) and _close(dv, rv)
    again = gattn.mha_packed_gqa_bwd(*args)
    assert all(torch.equal(a, b) for a, b in zip(again, (dq, dk, dv)))  # no atomics on the sums
    q, k, q_seg, kv_seg, q_offset = args[0], args[1], args[3], args[4], args[5]
    G, Dh = q.shape[2] // k.shape[2], q.shape[3]
    for got, ref in zip(gattn.bwd_tile_spans(q_seg, kv_seg, q_offset, G, Dh),
                        gattn.bwd_tile_spans_plain(q_seg, kv_seg, q_offset, G, Dh)):
        assert torch.equal(got, ref)


@pytest.mark.parametrize("extra", [0, 1])
@pytest.mark.parametrize("Dh,H,K", [(64, 14, 2), (128, 8, 1)])
def test_gqa_backward_on_split_edges(cuda, extra, Dh, H, K):
    """The first key tile's q span is exactly S * 2 tiles (extra 0) or S * 2 +
    1 (extra 1), S the shape's dk/dv split count: its blocks take equal
    shares, or one takes a tile more."""
    B, L = 1, 2048
    G, QR = H // K, gattn.dkv_q_rows(Dh)
    S = gattn.dkv_splits(B, L, L, K, G, Dh)
    first = S * 2 * QR // G + extra  # a segment whose rows fill S * 2 q tiles, or reach one more
    kv_seg = _segment_ids([first, 700, L - 700 - first], B, cuda)
    span = gattn.bwd_tile_spans_plain(kv_seg.cpu(), kv_seg.cpu(), 0, G, Dh)[1][0, 0].tolist()
    assert S > 1 and span == [0, S * 2 - 1 + extra]
    _check_bwd_kernels(_bwd_with_segments(torch.Generator(device=cuda).manual_seed(12), B, L, H, K, Dh, kv_seg, cuda))


@pytest.mark.parametrize(
    "B,L,H,K,Dh,layout",
    [
        (1, 1024, 14, 2, 64, "shuffled"),  # segments out of order
        (2, 600, 6, 2, 64, "random"),  # an id drawn at random for each position
        (1, 777, 8, 1, 128, "shuffled"),  # Dh 128, ragged
        (1, 4096, 14, 2, 64, "one"),  # one segment: the longest spans
    ],
)
def test_gqa_backward_on_unsorted_segment_ids(cuda, B, L, H, K, Dh, layout):
    rng = np.random.default_rng(L)
    if layout == "shuffled":
        lengths = rng.multinomial(L - 8 * 16, np.ones(8) / 8) + 16
        ids = np.repeat(rng.permutation(8), lengths)
    elif layout == "random":
        ids = rng.integers(0, 3, L)
    else:
        ids = np.zeros(L, np.int64)
    kv_seg = torch.from_numpy(ids.astype(np.int32))[None].expand(B, L).contiguous().to(cuda)
    _check_bwd_kernels(_bwd_with_segments(torch.Generator(device=cuda).manual_seed(13), B, L, H, K, Dh, kv_seg, cuda))


def test_gqa_backward_schedule_at_an_offset(cuda):
    """q_offset > 0 with Lq < Lkv, three segments: the device's schedule
    equals its plain version, and the kernels agree with the plain
    backward bit for bit on a second call."""
    gen = torch.Generator(device=cuda).manual_seed(14)
    args = _gqa_bwd_inputs(gen, 2, 96, 320, 8, 1, 128, 3, cuda)
    _check_bwd_kernels((*args[:5], args[5], 128**-0.5, *args[6:]))


def test_gqa_backward_fully_masked_row(cuda):
    """A query whose segment has no key: lse = -1e30, zero gradient, no NaN."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    q, k, v, q_seg, kv_seg, _, _, _, do = _gqa_bwd_inputs(gen, 1, 128, 128, 4, 2, 64, 1, cuda)
    q_seg = q_seg.clone()  # at Lq == Lkv it is kv_seg itself
    q_seg[0, 70] = 9
    out, lse = gattn.mha_packed_gqa(q, k, v, q_seg, kv_seg)
    dq, dk, dv = gattn.mha_packed_gqa_bwd(q, k, v, q_seg, kv_seg, 0, 0.125, out, lse, do)
    rq, rk, rv = gattn.mha_packed_gqa_bwd_plain(q, k, v, q_seg, kv_seg, 0, 0.125, out, lse, do)
    assert (lse[0, 70] == -1e30).all() and (dq[0, 70] == 0).all()
    assert all(torch.isfinite(t).all() for t in (dq, dk, dv))
    assert _close(dq, rq) and _close(dk, rk) and _close(dv, rv)


def test_gqa_autograd_runs_the_kernels(cuda):
    """Gradients through the autograd function (kernels #2-#4) against
    autograd through the plain forward, in fp32 from the same bf16 inputs."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    q, k, v, q_seg, kv_seg, _, _, _, do = _gqa_bwd_inputs(gen, 1, 512, 512, 14, 2, 64, 4, cuda)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = (gattn.launches, gattn.dq_launches, gattn.dkv_launches)
    out, _ = gattn.mha_packed_gqa(*leaves, q_seg, kv_seg)
    out.backward(do)
    torch.cuda.synchronize()
    assert (gattn.launches, gattn.dq_launches, gattn.dkv_launches) == tuple(b + 1 for b in before)
    ref_leaves = [t.float().requires_grad_() for t in (q, k, v)]
    ref_out, _ = gattn.mha_packed_gqa_plain(*ref_leaves, q_seg, kv_seg, 0)
    ref_out.backward(do.float())
    for got, ref in zip(leaves, ref_leaves):
        assert _close(got.grad, ref.grad)


def test_decode_kernel_takes_fp32_inputs_at_dh32(cuda):
    """An fp32-cache engine (bandit_cpu's width: hidden 64, 2 heads, Dh 32)
    runs the kernel; the wrapper casts where the JAX wrapper casts."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    S, H, K, Dh, T, W = 4, 2, 2, 32, 72, 4

    def f32(*shape):
        return torch.randn(shape, generator=gen, device=cuda)

    args = (f32(S, H, Dh), f32(S, K, Dh), f32(S, K, Dh), f32(S, T, K, Dh), f32(S, T, K, Dh),
            torch.tensor([0, 5, 33, 68], dtype=torch.int32, device=cuda), f32(W, S, K, Dh),
            f32(W, S, K, Dh), 2)
    before = dattn.launches
    out = dattn.decode_attention_staged_ragged(*args)
    torch.cuda.synchronize()
    assert dattn.launches == before + 1 and out.dtype == torch.float32
    ref = dattn.decode_attention_staged_ragged_plain(*args)
    assert (out - ref).abs().max().item() <= DECODE_ATOL


def test_fp32_engine_step_on_the_kernels(cuda):
    """bandit_cpu's engine (fp32 weights and cache, Dh 32, decode_attn_impl
    auto) runs the decode kernel; its logprobs agree with a teacher-forced
    forward through the plain fp32 attention within the kernel's bf16
    operand rounding (5e-2)."""
    from pipelinerl_tpu_torch.inference import EngineConfig, GenRequest, InferenceEngine, SamplingParams
    from pipelinerl_tpu_torch.models.transformer import ModelConfig, forward, init_params

    cfg = ModelConfig(vocab_size=260, hidden_size=64, intermediate_size=128, num_layers=2,
                      num_heads=2, num_kv_heads=2, dtype=torch.float32)
    params = init_params(torch.Generator(device=cuda).manual_seed(0), cfg, cuda)
    engine = InferenceEngine(
        params, cfg,
        EngineConfig(max_slots=4, max_len=64, prefill_buckets=(32, 64), cache_dtype=torch.float32,
                     decode_window=4, attn_impl="xla"),
        eos_token_id=-1, device=cuda,
    )
    assert engine.decode_attn_impl == "ragged"
    prompts = [[5 + i, 9, 3] for i in range(4)]
    before = dattn.launches
    futures = [engine.submit(GenRequest(p, SamplingParams(temperature=1.0, max_tokens=12))) for p in prompts]
    while not all(f.done() for f in futures):
        engine.step()
    assert dattn.launches > before
    for p, f in zip(prompts, futures):
        r = f.result()
        ids = torch.tensor([p + r.token_ids], device=cuda)
        T = ids.shape[1]
        with torch.no_grad():
            logits = forward(params, cfg, ids, torch.arange(T, device=cuda)[None],
                             torch.zeros((1, T), dtype=torch.int32, device=cuda))
        lp = torch.log_softmax(logits[0, len(p) - 1 : T - 1], -1).gather(-1, ids[0, len(p):, None])[:, 0]
        assert (lp.cpu() - torch.tensor(r.logprobs)).abs().max().item() <= 5e-2


def _engine_lens(S, BT, MAXB, W, seed):
    special = [0, 1, BT, BT + 1, MAXB * BT - W]
    return special + [int(x) for x in np.random.default_rng(seed).integers(0, 6 * BT, S - len(special))]


@pytest.mark.parametrize(
    "S,H,K,Dh,BT,MAXB,NB,W,lens,step",
    [
        # the paged engine's shape (Qwen2.5-0.5B heads, 96 slots, BT 128)
        (96, 14, 2, 64, 128, 33, 528, 32, _engine_lens(96, 128, 33, 32, 0), 0),
        (96, 14, 2, 64, 128, 33, 528, 32, _engine_lens(96, 128, 33, 32, 0), 31),
        # BT 16 < the 64-row tile: a tile spans four pages
        (4, 6, 2, 64, 16, 5, 24, 4, [0, 17, 33, 80], 3),
        # a stale length past MAXB * BT on a released (-1) table row
        (4, 6, 2, 64, 16, 5, 24, 4, [87, 5, 0, 40], 2),
        # the bandit_tpu engine with engine.kv_block_size=16 (H 4, K 2, 16 slots, W 8)
        (16, 4, 2, 64, 16, 5, 80, 8, [0, 1, 16, 17, 72] + list(range(20, 64, 4)), 7),
        # the prefix-cache engine (8 slots, W 16), its table sliced to 4 and 8 pages
        (8, 14, 2, 64, 128, 4, 136, 16, [0, 1, 128, 129, 496, 407, 464, 300], 15),
        (8, 14, 2, 64, 128, 8, 136, 16, [0, 1, 128, 129, 1008, 487, 544, 900], 15),
    ],
)
def test_paged_kernel_matches_plain(cuda, S, H, K, Dh, BT, MAXB, NB, W, lens, step):
    gen = torch.Generator(device=cuda).manual_seed(8)
    args = (_bf16(gen, S, H, Dh), _bf16(gen, S, K, Dh), _bf16(gen, S, K, Dh),
            _bf16(gen, NB, BT, K, Dh), _bf16(gen, NB, BT, K, Dh),
            scattered_table(S, BT, MAXB, NB, lens, 0).to(cuda), torch.tensor(lens, dtype=torch.int32, device=cuda),
            _bf16(gen, W, S, K, Dh), _bf16(gen, W, S, K, Dh), step)
    before = (pattn.launches, dattn.launches)
    out = pattn.paged_decode_attention(*args)
    torch.cuda.synchronize()
    assert (pattn.launches, dattn.launches) == (before[0] + 1, before[1])
    ref = pattn.paged_decode_attention_plain(*args)
    assert (out.float() - ref.float()).abs().max().item() <= DECODE_ATOL


@pytest.mark.parametrize(
    "BT,MAXB,NB,lens,step",
    [
        # the paged engine's pages: 17 splits; the longest length the table
        # allows and a stale one past it on a released row
        (128, 33, 264, SPLIT_EDGES + [33 * 128, 33 * 128 + 50, 1456], 0),
        (128, 33, 264, SPLIT_EDGES + [33 * 128, 33 * 128 + 50, 1456], 31),
        # BT 16: a split spans 16 pages
        (16, 40, 320, SPLIT_EDGES + [640, 650, 100], 3),
    ],
)
def test_paged_kernel_matches_plain_on_split_edges(cuda, BT, MAXB, NB, lens, step):
    gen = torch.Generator(device=cuda).manual_seed(11)
    S, H, K, Dh, W = len(lens), 14, 2, 64, 32
    args = (_bf16(gen, S, H, Dh), _bf16(gen, S, K, Dh), _bf16(gen, S, K, Dh),
            _bf16(gen, NB, BT, K, Dh), _bf16(gen, NB, BT, K, Dh),
            scattered_table(S, BT, MAXB, NB, lens, 2).to(cuda), torch.tensor(lens, dtype=torch.int32, device=cuda),
            _bf16(gen, W, S, K, Dh), _bf16(gen, W, S, K, Dh), step)
    out = pattn.paged_decode_attention(*args)
    torch.cuda.synchronize()
    ref = pattn.paged_decode_attention_plain(*args)
    assert (out.float() - ref.float()).abs().max().item() <= DECODE_ATOL
    assert torch.equal(pattn.paged_decode_attention(*args), out)  # no atomics on the sums
    # one split partition for both kernels: #1 over the gathered pages is #5
    slab = (*args[:3], pattn.gather_pages(args[3], args[5]), pattn.gather_pages(args[4], args[5]), *args[6:])
    assert torch.equal(dattn.decode_attention_staged_ragged(*slab), out)


def test_paged_kernel_reads_strided_layer_slices_and_fp32(cuda):
    """The engine hands the kernel per-layer slices of [L, NB, BT, K, Dh] and
    [L, W, S, K, Dh]; an fp32 engine's inputs are cast where JAX casts."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    L, S, H, K, Dh, BT, MAXB, NB, W = 3, 4, 4, 2, 32, 16, 5, 24, 4
    lens = [3, 0, 79, 20]
    table = scattered_table(S, BT, MAXB, NB, lens, 1).to(cuda)
    lens_t = torch.tensor(lens, dtype=torch.int32, device=cuda)
    kp, vp = _bf16(gen, L, NB, BT, K, Dh), _bf16(gen, L, NB, BT, K, Dh)
    ks, vs = _bf16(gen, L, W, S, K, Dh), _bf16(gen, L, W, S, K, Dh)
    q, kn, vn = _bf16(gen, S, H, Dh), _bf16(gen, S, K, Dh), _bf16(gen, S, K, Dh)
    for dtype in (torch.bfloat16, torch.float32):
        args = [t.to(dtype) for t in (q, kn, vn, kp[1], vp[1])] + [table, lens_t] + [t.to(dtype) for t in (ks[2], vs[2])]
        out = pattn.paged_decode_attention(*args, 2)
        ref = pattn.paged_decode_attention_plain(*args, 2)
        assert out.dtype == dtype and (out.float() - ref.float()).abs().max().item() <= DECODE_ATOL


def test_paged_engine_on_the_kernel(cuda):
    """A paged fp32 engine (decode_attn_impl auto: kernel #5) with a GRPO
    group: logprobs agree with a teacher-forced forward through the plain
    fp32 attention within the kernel's bf16 operand rounding (5e-2); kernel
    #1 never runs, and every page returns to the pool."""
    from pipelinerl_tpu_torch.inference import EngineConfig, GenRequest, InferenceEngine, SamplingParams
    from pipelinerl_tpu_torch.models.transformer import ModelConfig, forward, init_params

    cfg = ModelConfig(vocab_size=260, hidden_size=64, intermediate_size=128, num_layers=2,
                      num_heads=2, num_kv_heads=2, dtype=torch.float32)
    params = init_params(torch.Generator(device=cuda).manual_seed(0), cfg, cuda)
    engine = InferenceEngine(
        params, cfg,
        EngineConfig(max_slots=6, max_len=96, prefill_buckets=(32, 64), cache_dtype=torch.float32,
                     decode_window=4, attn_impl="xla", kv_layout="paged", kv_block_size=16),
        eos_token_id=-1, device=cuda,
    )
    assert engine.decode_attn_impl == "ragged"
    prompts = [[5 + i, 9, 3] * (i + 1) for i in range(3)] + [[7] * 20] * 3
    before = (pattn.launches, dattn.launches)
    futures = [engine.submit(GenRequest(p, SamplingParams(temperature=1.0, max_tokens=30))) for p in prompts]
    while not all(f.done() for f in futures):
        engine.step()
    assert pattn.launches - before[0] == cfg.num_layers * engine.decode_steps
    assert dattn.launches == before[1]
    engine.block_pool.check_invariants()
    assert engine.prefix_cache.evict_for(engine.block_pool.n_blocks)  # only the cache held pages
    for p, f in zip(prompts, futures):
        r = f.result()
        ids = torch.tensor([p + r.token_ids], device=cuda)
        T = ids.shape[1]
        with torch.no_grad():
            logits = forward(params, cfg, ids, torch.arange(T, device=cuda)[None],
                             torch.zeros((1, T), dtype=torch.int32, device=cuda))
        lp = torch.log_softmax(logits[0, len(p) - 1 : T - 1], -1).gather(-1, ids[0, len(p):, None])[:, 0]
        assert (lp.cpu() - torch.tensor(r.logprobs)).abs().max().item() <= 5e-2


def test_kernels_refuse_what_they_do_not_take(cuda):
    gen = torch.Generator(device=cuda).manual_seed(3)
    q = torch.randn((1, 64, 4, 64), generator=gen, device=cuda)  # fp32
    k = torch.randn((1, 64, 2, 64), generator=gen, device=cuda)
    seg = torch.zeros((1, 64), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        gattn.mha_packed_gqa(q, k, k, seg, seg)
    # inputs that require grad now run the autograd path (kernels #2-#4)
    qb = q.to(torch.bfloat16).requires_grad_()
    out, _ = gattn.mha_packed_gqa(qb, k.to(torch.bfloat16), k.to(torch.bfloat16), seg, seg)
    out.sum().backward()
    assert qb.grad is not None and torch.isfinite(qb.grad.float()).all()
    S, K, Dh, T, W = 2, 2, 48, 16, 4  # Dh 48 is not a kernel width
    x = torch.zeros((S, 4, Dh), dtype=torch.bfloat16, device=cuda)
    kv = torch.zeros((S, K, Dh), dtype=torch.bfloat16, device=cuda)
    cache = torch.zeros((S, T, K, Dh), dtype=torch.bfloat16, device=cuda)
    band = torch.zeros((W, S, K, Dh), dtype=torch.bfloat16, device=cuda)
    lens = torch.zeros(S, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        dattn.decode_attention_staged_ragged(x, kv, kv, cache, cache, lens, band, band, 0)
    pool = torch.zeros((3, 16, K, Dh), dtype=torch.bfloat16, device=cuda)
    table = torch.zeros((S, 2), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        pattn.paged_decode_attention(x, kv, kv, pool, pool, table, lens, band, band, 0)
    with pytest.raises(ValueError):  # an int64 table
        ok = torch.zeros((S, 4, 64), dtype=torch.bfloat16, device=cuda)
        okv = torch.zeros((S, K, 64), dtype=torch.bfloat16, device=cuda)
        okp = torch.zeros((3, 16, K, 64), dtype=torch.bfloat16, device=cuda)
        okb = torch.zeros((W, S, K, 64), dtype=torch.bfloat16, device=cuda)
        pattn.paged_decode_attention(ok, okv, okv, okp, okp, table.long(), lens, okb, okb, 0)


def test_safetensors_round_trip_onto_the_card(cuda, tmp_path):
    """A checkpoint written from card tensors (transposed views among them)
    and read back through ``load_hf_model`` onto the card, bit for bit."""
    from pipelinerl_tpu_torch.models.hf_loader import load_hf_model
    from pipelinerl_tpu_torch.models.transformer import ModelConfig, init_params
    from pipelinerl_tpu_torch.train.checkpoints import export_hf
    from pipelinerl_tpu_torch.utils import safetensors_io

    gen = torch.Generator(device=cuda).manual_seed(0)
    tensors = {"bf16.t": _bf16(gen, 64, 96).T, "f32": torch.randn(5, 7, generator=gen, device=cuda),
               "i64": torch.arange(-3, 9, device=cuda), "empty": torch.zeros(0, 3, device=cuda)}
    safetensors_io.save_file(tensors, tmp_path / "x.safetensors")
    back = safetensors_io.load_file(tmp_path / "x.safetensors")
    for name, t in tensors.items():
        assert torch.equal(back[name].to(cuda), t), name

    cfg = ModelConfig(vocab_size=512, hidden_size=128, intermediate_size=256, num_layers=2, num_heads=2,
                      num_kv_heads=1, head_dim=64, attention_bias=True, tie_word_embeddings=True,
                      dtype=torch.bfloat16, hf_architecture="Qwen2ForCausalLM")
    params = init_params(gen, cfg, cuda)
    loaded, loaded_cfg = load_hf_model(export_hf(tmp_path, params, cfg), device=cuda)
    assert loaded_cfg == cfg
    for key in ("embed", "final_norm"):
        assert loaded[key].is_cuda and torch.equal(loaded[key], params[key])
    for name, w in params["layers"].items():
        assert torch.equal(loaded["layers"][name], w), name


def test_gqa_kernels_match_the_blocked_plain_versions_on_a_long_row(cuda):
    """#2-#4 on an L 8,192 row (three segments and a long causal tail, as a
    padded packed row is) against the plain forward and backward by blocks
    of 1,024 queries, which is how the card checks the L 32,768 row."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    L, H, K, Dh = 8192, 14, 2, 64
    q, k, v, do = _bf16(gen, 1, L, H, Dh), _bf16(gen, 1, L, K, Dh), _bf16(gen, 1, L, K, Dh), _bf16(gen, 1, L, H, Dh)
    seg = torch.repeat_interleave(torch.arange(4, dtype=torch.int32, device=cuda),
                                  torch.tensor([700, 1300, 500, L - 2500], device=cuda))[None].contiguous()
    out, lse = gattn.mha_packed_gqa(q, k, v, seg, seg, 0)
    ref_out, ref_lse = gattn.mha_packed_gqa_plain_blocked(q, k, v, seg, seg, 0, block=1024)
    assert (out.float() - ref_out.float()).abs().max().item() <= GQA_OUT_ATOL
    # the long segment's outputs are about sqrt(e / 5,692) = 0.02, the size
    # of the absolute limit: each token's row is also held relative to its size
    assert row_rel_err(out, ref_out, 2) <= OUT_ROW_RTOL
    assert (lse - ref_lse).abs().max().item() <= GQA_LSE_ATOL
    grads = gattn.mha_packed_gqa_bwd(q, k, v, seg, seg, 0, Dh**-0.5, out, lse, do)
    refs = gattn.mha_packed_gqa_bwd_plain_blocked(q, k, v, seg, seg, 0, Dh**-0.5, out, lse, do, block=1024)
    for g, r in zip(grads, refs):
        # bf16 outputs, P and dS rounded to bf16 where fp32 sums run in
        # another order: 1e-2 of the largest reference value
        assert (g.float() - r.float()).abs().max().item() <= 1e-2 * max(1.0, r.float().abs().max().item())


@pytest.mark.parametrize("optim", ["lion", "adafactor"])
def test_lion_and_adafactor_on_the_card_match_the_cpu(cuda, optim):
    """Three bf16 steps on a stacked layout that Adafactor factors: the
    card's params and state equal the CPU's within one bf16 rounding (the
    card's reductions sum in another order)."""
    from pipelinerl_tpu_torch.train.optimizers import Adafactor, Lion

    gen = torch.Generator().manual_seed(3)
    shapes = [(2, 132, 192), (2, 132), (160, 132), (132,)]
    init = [torch.randn(s, generator=gen).bfloat16() for s in shapes]
    grads = [[(torch.randn(s, generator=gen) * 0.01).bfloat16() for s in shapes] for _ in range(3)]
    runs = []
    for dev in ("cpu", cuda):
        params = [p.clone().to(dev) for p in init]
        opt = Lion(params, lr=1e-2, weight_decay=0.1) if optim == "lion" else Adafactor(params, lr=1e-2)
        for step_grads in grads:
            for p, g in zip(params, step_grads):
                p.grad = g.to(dev)
            opt.step()
        state = [t.cpu().float() for p in params for t in opt.state[p].values() if t.is_floating_point()]
        runs.append(([p.cpu().float() for p in params], state))
    for a, b in zip(runs[0][0] + runs[0][1], runs[1][0] + runs[1][1]):
        torch.testing.assert_close(b, a, rtol=2**-7, atol=1e-6)


@pytest.mark.parametrize("cp", [2, 4])
def test_cp_attention_slices_match_the_plain_row(cuda, cp):
    """What each rank of ``parallel.cp_attention`` runs: its slice of a
    packed row's queries (q_offset rank * L/cp) against the gathered keys,
    forward and backward through #2-#4, against autograd through the plain
    forward of the whole row in fp32; the ranks' dk/dv summed, as the
    gather's backward reduce-scatters them. Segments cross the slices."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    B, L, H, K, Dh = 1, 4096, 14, 2, 64
    c = L // cp
    q, k, v, do = _bf16(gen, B, L, H, Dh), _bf16(gen, B, L, K, Dh), _bf16(gen, B, L, K, Dh), _bf16(gen, B, L, H, Dh)
    seg = _segment_ids([700, 1500, 300, 1100, 496], B, cuda)
    ref = [t.float().requires_grad_() for t in (q, k, v)]
    ref_out, _ = gattn.mha_packed_gqa_plain(*ref, seg, seg, 0)
    ref_out.backward(do.float())
    dk, dv = torch.zeros(k.shape, device=cuda), torch.zeros(v.shape, device=cuda)
    for rank in range(cp):
        rows = slice(rank * c, (rank + 1) * c)
        leaves = [t.clone().requires_grad_() for t in (q[:, rows].contiguous(), k, v)]
        before = (gattn.launches, gattn.dq_launches, gattn.dkv_launches)
        out, _ = gattn.mha_packed_gqa(*leaves, seg[:, rows].contiguous(), seg, rank * c)
        out.backward(do[:, rows])
        torch.cuda.synchronize()
        assert (gattn.launches, gattn.dq_launches, gattn.dkv_launches) == tuple(b + 1 for b in before)
        assert _close(out, ref_out[:, rows]) and _close(leaves[0].grad, ref[0].grad[:, rows])
        dk += leaves[1].grad.float()
        dv += leaves[2].grad.float()
    assert _close(dk, ref[1].grad) and _close(dv, ref[2].grad)
