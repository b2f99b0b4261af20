"""The port's paged decode attention and ``paged_append`` against the JAX
package's: the plain version of kernel #5 against the Pallas kernel
(interpret mode off TPU) and against the XLA reference, and the indexed
append against JAX's dropping scatter, on the same numpy inputs. Also the
CUDA kernel's split plan over MAXB * BT rows, and the plain model of its
split-and-merge arithmetic over the gathered pages."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from pipelinerl_tpu.ops import paged_attention as jpa
from pipelinerl_tpu_torch.inference.block_pool import BlockPool
from pipelinerl_tpu_torch.ops import decode_attention as dattn
from pipelinerl_tpu_torch.ops import paged_attention as tpa
from tests.test_torch_decode_attention import split_merge_model

torch.set_num_threads(1)
S, H, K, Dh = 4, 4, 2, 8
BT, NB, MAXB, W = 16, 24, 5, 4
# both sides round operands and P to bf16 and sum in fp32, in another order
# (the Pallas kernel takes its running max per page, the plain version over
# all rows at once)
PALLAS_ATOL = 2e-2
# the XLA reference keeps fp32 operands, so bf16 rounding counts in full, as
# in the JAX package's own test of its kernel
XLA_ATOL = 5e-2

LENS = {
    "jax-test lens": [3, BT, 2 * BT + 5, MAXB * BT - 1],
    "empty slot": [0, 1, BT + 1, MAXB * BT - 1],
    # an inactive slot: a stale length past MAXB * BT and a released table row
    "stale length, released row": [MAXB * BT + 7, 5, 0, 2 * BT],
}


def make_inputs(seed, lens, nb=NB, maxb=MAXB):
    """Pool, a table whose pages come out of order, and the step's inputs."""
    rng = np.random.default_rng(seed)
    pool = BlockPool(n_blocks=nb, block_size=BT, max_blocks_per_slot=maxb, n_slots=S)
    pool.allocate(S - 1, 3 * BT)  # a first occupant, released below: pages reused
    pool.release(S - 1)
    for s, n in enumerate(lens):
        pool.allocate(s, min(max(n, 1), maxb * BT))
    for s, n in enumerate(lens):
        if n > maxb * BT:
            pool.release(s)
    mk = lambda *shape: rng.normal(size=shape).astype(np.float32)
    return dict(
        q=mk(S, H, Dh), k_new=mk(S, K, Dh), v_new=mk(S, K, Dh), k_pool=mk(nb, BT, K, Dh),
        v_pool=mk(nb, BT, K, Dh), block_table=pool.table.copy(), lens=np.asarray(lens, np.int32),
        k_staged=mk(W, S, K, Dh), v_staged=mk(W, S, K, Dh),
    )


def run_both(j_fn, a, step):
    j_out = j_fn(*(jnp.asarray(x) for x in a.values()), jnp.asarray(step))
    t_out = tpa.paged_decode_attention_plain(*(torch.from_numpy(x) for x in a.values()), step)
    return t_out.numpy(), np.asarray(j_out)


@pytest.mark.parametrize("step", [0, 3])
@pytest.mark.parametrize("case", list(LENS))
def test_plain_matches_pallas_kernel(case, step):
    t_out, j_out = run_both(jpa.paged_decode_attention, make_inputs(0, LENS[case]), step)
    np.testing.assert_allclose(t_out, j_out, rtol=0, atol=PALLAS_ATOL)


@pytest.mark.parametrize("case", list(LENS))
def test_plain_matches_xla_reference_fp32(case):
    t_out, j_out = run_both(jpa.paged_decode_attention_xla, make_inputs(1, LENS[case]), 2)
    np.testing.assert_allclose(t_out, j_out, rtol=0, atol=XLA_ATOL)


@pytest.mark.parametrize("case", list(LENS))
def test_plain_is_ragged_plain_on_the_gathered_view(case):
    a = {k: torch.from_numpy(v) for k, v in make_inputs(2, LENS[case]).items()}
    table = a["block_table"].long().clamp(0, NB - 1)
    kc = a["k_pool"][table].reshape(S, MAXB * BT, K, Dh)
    vc = a["v_pool"][table].reshape(S, MAXB * BT, K, Dh)
    want = dattn.decode_attention_staged_ragged_plain(
        a["q"], a["k_new"], a["v_new"], kc, vc, a["lens"], a["k_staged"], a["v_staged"], 1
    )
    assert torch.equal(tpa.paged_decode_attention_plain(*a.values(), 1), want)


def test_wrapper_sends_cpu_tensors_to_the_plain_version():
    a = [torch.from_numpy(x) for x in make_inputs(3, LENS["jax-test lens"]).values()]
    before = tpa.launches
    out = tpa.paged_decode_attention(*a, 2)
    assert tpa.launches == before
    assert torch.equal(out, tpa.paged_decode_attention_plain(*a, 2))


@pytest.mark.parametrize(
    "bt,maxb,splits",
    # the paged engine's snapshots (16 pages of 128) and case (i) (33 pages);
    # BT 16 at the bandit_tpu engine's 5 pages and at 33 pages
    [(128, 16, 8), (128, 33, 17), (16, 5, 1), (16, 33, 3)],
)
def test_split_plan_over_the_table(bt, maxb, splits):
    assert tpa.split_plan(maxb * bt) == splits


C = tpa.SPLIT_ROWS
# (label, table width, lengths, chunk rows, tile rows): lengths on the split
# edges at the kernel's chunk (a 40-page table of BT 16 holds 640 rows),
# and at 32-row chunks of 16-row tiles over 5 pages; stale lengths on
# released rows in both
SPLIT_CASES = {
    "C edges, 40 pages": (40, [0, C - 1, C, C + 1], 256, 64),
    "2C + 1, the longest, a stale length": (40, [2 * C + 1, 40 * BT, 40 * BT + 9, 0], 256, 64),
    "32-row chunks": (MAXB, [MAXB * BT + 7, 31, 33, MAXB * BT], 32, 16),
}


@pytest.mark.parametrize("step", [0, 3])
@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_split_merge_model_matches_plain_and_pallas(case, step):
    maxb, lens, split_rows, tile = SPLIT_CASES[case]
    a = make_inputs(6, lens, nb=S * maxb, maxb=maxb)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    view = [tpa.gather_pages(t[name], t["block_table"]) for name in ("k_pool", "v_pool")]
    model = split_merge_model(t["q"], t["k_new"], t["v_new"], *view, t["lens"], t["k_staged"], t["v_staged"],
                              step, split_rows=split_rows, tile=tile)
    _, j_out = run_both(jpa.paged_decode_attention, a, step)
    plain = tpa.paged_decode_attention_plain(*t.values(), step)
    # P is rounded against each chunk's running max, not the row's max
    np.testing.assert_allclose(model.numpy(), plain.numpy(), rtol=0, atol=PALLAS_ATOL)
    np.testing.assert_allclose(model.numpy(), j_out, rtol=0, atol=PALLAS_ATOL)


APPEND_CASES = {
    "within and across pages": ([BT - 2, 5, 0, BT], None),
    "dropped by count": ([3, 17, 40, 9], [7, 0, 2, 5]),
    "dropped by table overflow": ([MAXB * BT - 3, 1, MAXB * BT + 4, 30], [6, 7, 7, 1]),
}


@pytest.mark.parametrize("case", list(APPEND_CASES))
def test_paged_append_matches_jax(case):
    lens, count = APPEND_CASES[case]
    rng = np.random.default_rng(4)
    R = 7
    pool = BlockPool(n_blocks=NB, block_size=BT, max_blocks_per_slot=MAXB, n_slots=S)
    for s, n in enumerate(lens):
        pool.allocate(s, min(n + R, MAXB * BT))
    k_pool = rng.normal(size=(NB, BT, K, Dh)).astype(np.float32)
    rows = rng.normal(size=(S, R, K, Dh)).astype(np.float32)
    lens = np.asarray(lens, np.int32)
    cnt = None if count is None else np.asarray(count, np.int32)
    want = np.asarray(jpa.paged_append(
        jnp.asarray(k_pool), jnp.asarray(rows), jnp.asarray(pool.table), jnp.asarray(lens),
        None if cnt is None else jnp.asarray(cnt),
    ))
    got = torch.from_numpy(k_pool.copy())
    out = tpa.paged_append(got, torch.from_numpy(rows), torch.from_numpy(pool.table),
                           torch.from_numpy(lens), None if cnt is None else torch.from_numpy(cnt))
    assert out is got  # in place
    np.testing.assert_array_equal(got.numpy(), want)
    if count is not None:
        assert not np.array_equal(want, k_pool)
    # the same rows through a stacked [L, NB, ...] pool, one layer each
    stacked = torch.from_numpy(np.stack([k_pool, 2 * k_pool]))
    tpa.paged_append(stacked, torch.from_numpy(np.stack([rows, 3 * rows])), torch.from_numpy(pool.table),
                     torch.from_numpy(lens), None if cnt is None else torch.from_numpy(cnt))
    np.testing.assert_array_equal(stacked[0].numpy(), want)
    want1 = np.asarray(jpa.paged_append(
        jnp.asarray(2 * k_pool), jnp.asarray(3 * rows), jnp.asarray(pool.table), jnp.asarray(lens),
        None if cnt is None else jnp.asarray(cnt),
    ))
    np.testing.assert_array_equal(stacked[1].numpy(), want1)


def test_paged_append_with_nothing_kept_changes_nothing():
    rng = np.random.default_rng(5)
    pool = rng.normal(size=(NB, BT, K, Dh)).astype(np.float32)
    table = np.full((S, MAXB), -1, np.int32)
    out = tpa.paged_append(torch.from_numpy(pool.copy()), torch.from_numpy(rng.normal(size=(S, 4, K, Dh)).astype(np.float32)),
                           torch.from_numpy(table), torch.zeros(S, dtype=torch.int32), torch.zeros(S, dtype=torch.int32))
    np.testing.assert_array_equal(out.numpy(), pool)
