"""The port's paged KV engine: greedy parity with the JAX package's paged
engine on identical fp32 weights (both decode routes), and the port's
counterparts of tests/test_engine_paged.py (slab parity, fork page sharing,
admission deferral, table buckets, the prefix cache, ``auto`` → slab), plus
``launch.build_engine`` building the layout from a config."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pipelinerl_tpu.inference import engine as je
from pipelinerl_tpu.models import transformer as jt
from pipelinerl_tpu_torch import launch
from pipelinerl_tpu_torch.config import compose
from pipelinerl_tpu_torch.inference import engine as te
from pipelinerl_tpu_torch.models import transformer as tt

torch.set_num_threads(1)
EOS = 250
KW = dict(vocab_size=260, hidden_size=32, intermediate_size=64, num_layers=2, num_heads=2, num_kv_heads=2)


@pytest.fixture(scope="module")
def model():
    """The JAX test's model (fp32, seed 0), its weights carried to the port."""
    jcfg = jt.ModelConfig(dtype=jnp.float32, **KW)
    jparams = jt.init_params(jax.random.key(0), jcfg)
    tcfg = tt.ModelConfig(dtype=torch.float32, **KW)
    return jparams, jcfg, tt.params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, "cpu"), tcfg


def engine_kw(layout, **over):
    """The JAX test's engine (tests/test_engine_paged.py:27-40)."""
    kw = dict(max_slots=4, max_len=96, prefill_buckets=(32, 64), decode_window=4,
              window_pipeline_depth=1, kv_layout=layout, kv_block_size=16)
    kw.update(over)
    return kw


def make_engine(model, layout, **over):
    _, _, params, cfg = model
    return te.InferenceEngine(params, cfg, te.EngineConfig(cache_dtype=torch.float32, **engine_kw(layout, **over)),
                              eos_token_id=EOS, device="cpu")


def drain(engine, futures):
    for _ in range(3000):
        engine.step()
        if all(f.done() for f in futures):
            return [f.result() for f in futures]
    raise TimeoutError("engine did not finish")


def greedy(prompt, max_tokens=10, cls=te):
    return cls.GenRequest(list(prompt), cls.SamplingParams(temperature=0.0, max_tokens=max_tokens))


def run(engine, prompts, max_tokens=10):
    return drain(engine, [engine.submit(greedy(p, max_tokens)) for p in prompts])


def assert_same(got, want, atol):
    for g, w in zip(got, want):
        assert g.token_ids == w.token_ids, (g.token_ids, w.token_ids)
        assert g.finish_reason == w.finish_reason
        np.testing.assert_allclose(g.logprobs, w.logprobs, rtol=0, atol=atol)


# ---------------------------------------------------------------------------
# against the JAX paged engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("route", ["xla", "ragged"])
def test_paged_engine_matches_jax_paged_engine(model, route):
    """Greedy tokens equal, logprobs within 1e-2: "xla" gathers a contiguous
    view per window on both sides (fp32); "ragged" is the Pallas kernel in
    interpret mode against the plain version of kernel #5 (bf16 operands
    and P on both sides). A GRPO group forks, and a second wave reuses a
    cached prefix."""
    jparams, jcfg, _, _ = model
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 200, n).tolist() for n in (5, 17, 31, 23)]
    group = [rng.integers(1, 200, 20).tolist()] * 3
    j_engine = je.InferenceEngine(
        jparams, jcfg, je.EngineConfig(cache_dtype=jnp.float32, decode_attn_impl=route, **engine_kw("paged")),
        eos_token_id=EOS,
    )
    t_engine = make_engine(model, "paged", decode_attn_impl=route)
    j_first = drain(j_engine, [j_engine.submit(greedy(p, 10, je)) for p in prompts + group])
    t_first = run(t_engine, prompts + group)
    assert_same(t_first, j_first, 1e-2)
    second = [prompts[2] + t_first[2].token_ids + [7, 9, 11]]
    assert_same(run(t_engine, second), drain(j_engine, [j_engine.submit(greedy(second[0], 10, je))]), 1e-2)
    assert t_engine.perf_counters()["prefix_cache_hits"] == j_engine.perf_counters()["prefix_cache_hits"] >= 1
    assert t_engine.block_pool.table.tolist() == j_engine.block_pool.table.tolist()
    assert t_engine.block_pool.refs.tolist() == j_engine.block_pool.refs.tolist()


def test_whole_page_transcript_registers_one_page_fewer_than_jax(model):
    """Where prompt + completion fills a whole number of pages (27 + 5 = 32
    tokens, two pages), the port registers the transcript without its final
    token (one page) and the JAX paged engine with it (two pages; that
    token's K/V row may be unwritten). Both engines agree on the first turn;
    the follow-up prompt then hits once on each, reusing 16 tokens here and
    32 there. A JAX-side fix shows as equal counts."""
    jparams, jcfg, _, _ = model
    prompt1 = np.random.default_rng(0).integers(1, 200, 27).tolist()
    j_engine = je.InferenceEngine(
        jparams, jcfg, je.EngineConfig(cache_dtype=jnp.float32, decode_attn_impl="xla", **engine_kw("paged")),
        eos_token_id=EOS,
    )
    t_engine = make_engine(model, "paged", decode_attn_impl="xla")
    (j1,) = drain(j_engine, [j_engine.submit(greedy(prompt1, 5, je))])
    (t1,) = run(t_engine, [prompt1], 5)
    assert_same([t1], [j1], 1e-2)
    assert len(t1.token_ids) == 5
    assert (t_engine.prefix_cache.pages_held, j_engine.prefix_cache.pages_held) == (1, 2)
    prompt2 = prompt1 + t1.token_ids + [7, 9, 11]
    drain(j_engine, [j_engine.submit(greedy(prompt2, 4, je))])
    run(t_engine, [prompt2], 4)
    tc, jc = t_engine.perf_counters(), j_engine.perf_counters()
    assert tc["prefix_cache_hits"] == jc["prefix_cache_hits"] == 1
    assert (tc["prefix_cache_reused_tokens"], jc["prefix_cache_reused_tokens"]) == (16, 32)


# ---------------------------------------------------------------------------
# counterparts of tests/test_engine_paged.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("route", ["xla", "ragged"])
def test_paged_matches_slab_greedy(model, route):
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 200, n).tolist() for n in (5, 17, 31, 23)]
    ref = run(make_engine(model, "slab", decode_attn_impl=route), prompts)
    engine = make_engine(model, "paged", decode_attn_impl=route)
    assert engine.paged and not hasattr(engine, "k_cache")
    # the same arithmetic over a contiguous cache and over gathered pages
    assert_same(run(engine, prompts), ref, 1e-5)


def test_paged_fork_shares_prompt_pages(model):
    prompt = np.random.default_rng(1).integers(1, 200, 20).tolist()  # one full page + a tail
    engine = make_engine(model, "paged", prefix_cache=False)
    futures = [engine.submit(greedy(prompt, 6)) for _ in range(4)]
    engine.step()  # admission, then the first window
    assert engine.prefill_reused_tokens == 3 * 20
    pool = engine.block_pool
    shared = pool.table[0, 0]
    assert pool.refs[shared] == 4 and (pool.table[:, 0] == shared).all()
    assert len({int(pool.table[s, 1]) for s in range(4)}) == 4  # each tail page its own
    results = drain(engine, futures)
    assert all(r.token_ids == results[0].token_ids for r in results[1:])
    assert pool.free_blocks == pool.n_blocks
    pool.check_invariants()


def test_paged_fork_on_a_page_boundary_copies_nothing(model):
    prompt = np.random.default_rng(6).integers(1, 200, 32).tolist()  # two full pages
    engine = make_engine(model, "paged", prefix_cache=False)
    futures = [engine.submit(greedy(prompt, 6)) for _ in range(3)]
    engine.step()
    pool = engine.block_pool
    assert all(pool.refs[pool.table[0, j]] == 3 for j in (0, 1))
    results = drain(engine, futures)
    assert all(r.token_ids == results[0].token_ids for r in results[1:])
    assert pool.free_blocks == pool.n_blocks


def test_paged_pool_exhaustion_defers_admission(model):
    rng = np.random.default_rng(2)
    # each request reserves 31 + 10 + 4 = 45 tokens: 3 pages of 16
    engine = make_engine(model, "paged", kv_pool_blocks=6, prefix_cache=False)
    futures = [engine.submit(greedy(rng.integers(1, 200, 31).tolist(), 10)) for _ in range(5)]
    engine.step()
    assert engine.num_active <= 2 and engine.num_pending == 3  # deferred despite free slots
    for r in drain(engine, futures):
        assert r.finish_reason in ("stop", "length") and len(r.token_ids) >= 1
    assert engine.block_pool.free_blocks == 6
    engine.block_pool.check_invariants()


@pytest.mark.parametrize("route", ["xla", "ragged"])
def test_paged_bucket_growth_and_shrink_parity(model, route):
    """The window's table is sliced to the power-of-two bucket of the most
    pages an active slot holds: it grows when a long request joins and
    shrinks when it leaves, with greedy parity against slab throughout."""
    rng = np.random.default_rng(7)
    short = rng.integers(1, 200, 6).tolist()  # 6 + 8 + 4 tokens: 2 pages, bucket 2
    long = rng.integers(1, 200, 9).tolist()  # 9 + 70 + 4 tokens: 6 pages, bucket 8 cut to MAXB 7

    def phases(layout):
        engine = make_engine(model, layout, decode_attn_impl=route)
        widths = []
        if layout == "paged":
            inner = te._decode_window_paged_fn

            def spy(*args, **kw):
                widths.append(args[6].shape[1])
                return inner(*args, **kw)

            te._decode_window_paged_fn = spy
        try:
            out = run(engine, [short], 8)
            out += drain(engine, [engine.submit(greedy(long, 70)), engine.submit(greedy(short, 8))])
            out += run(engine, [short], 8)
        finally:
            if layout == "paged":
                te._decode_window_paged_fn = inner
        return out, widths

    ref, _ = phases("slab")
    got, widths = phases("paged")
    assert_same(got, ref, 1e-5)
    assert widths[0] == 2 and max(widths) == 7 and widths[-1] == 2


def test_paged_counters_and_abort(model):
    engine = make_engine(model, "paged", prefix_cache=False)
    fut = engine.submit(te.GenRequest(np.random.default_rng(3).integers(1, 200, 8).tolist(),
                                      te.SamplingParams(temperature=1.0, max_tokens=40), "abortme"))
    engine.step()
    counters = engine.perf_counters()
    assert counters["kv_pages_total"] == engine.block_pool.n_blocks == 4 * 7  # S * ceil(100 / 16)
    assert counters["kv_pages_free"] < counters["kv_pages_total"]
    assert "prefix_cache_hits" not in counters
    engine.abort("abortme")
    engine.step()
    assert fut.result(timeout=5).finish_reason == "abort"
    assert engine.block_pool.free_blocks == engine.block_pool.n_blocks


def test_prefix_cache_reuses_transcript_pages(model):
    """A prompt that extends a finished transcript reattaches its full pages,
    prefills only the tail, and gives exactly the tokens of a cold engine."""
    rng = np.random.default_rng(1)
    prompt1 = rng.integers(1, 240, 20).tolist()
    warm = make_engine(model, "paged", prefix_cache=True)
    (r1,) = run(warm, [prompt1], 8)
    prompt2 = prompt1 + r1.token_ids + rng.integers(1, 240, 6).tolist()
    (r2_warm,) = run(warm, [prompt2], 8)
    c = warm.perf_counters()
    assert c["prefix_cache_hits"] >= 1 and c["prefix_cache_reused_tokens"] >= 16
    assert c["prefill_extend_batches"] == 1 and warm.prefill_reused_tokens >= 16
    (r2_cold,) = run(make_engine(model, "paged", prefix_cache=False), [prompt2], 8)
    assert_same([r2_warm], [r2_cold], 1e-5)


def test_prefix_cache_multi_turn_conversation(model):
    """Every turn after the first reuses the previous transcript's pages: the
    prefilled tokens stay near the sum of per-turn deltas."""
    rng = np.random.default_rng(2)
    engine = make_engine(model, "paged", max_len=512, prefill_buckets=(32, 64, 128, 256, 512),
                         kv_pool_blocks=256)
    transcript = rng.integers(1, 240, 24).tolist()
    turns = 8
    for _ in range(turns):
        (res,) = run(engine, [transcript], 4)
        transcript = transcript + res.token_ids + rng.integers(1, 240, 6).tolist()
    c = engine.perf_counters()
    assert c["prefix_cache_hits"] >= turns - 1
    naive = sum(24 + i * 10 for i in range(turns))  # every turn prefilled whole
    assert c["prefill_tokens"] < naive * 0.6, c


def test_prefix_cache_eviction_under_pressure(model):
    rng = np.random.default_rng(3)
    engine = make_engine(model, "paged", max_slots=2, kv_pool_blocks=12)
    for _ in range(6):
        run(engine, [rng.integers(1, 240, 20).tolist()], 8)
    c = engine.perf_counters()
    assert c["prefix_cache_pages"] > 0
    assert c["kv_pages_free"] + c["prefix_cache_pages"] <= 12
    engine.block_pool.check_invariants()
    # a request that needs most of the pool evicts the cache rather than wait
    (r,) = run(engine, [rng.integers(1, 240, 60).tolist()], 30)
    assert r.finish_reason in ("stop", "length")
    engine.block_pool.check_invariants()


def test_prefix_extend_batched_heterogeneous_wave(model):
    """Two lineages with different prefix lengths (3 and 4 pages, one page
    bucket) extended in one admission wave share one batched extend, the
    shorter prefix padded with a repeated page, and match a cold engine."""
    rng = np.random.default_rng(7)
    over = dict(max_len=256, prefill_buckets=(32, 64, 128, 256), kv_pool_blocks=128)
    warm = make_engine(model, "paged", prefix_cache=True, **over)
    base_a = rng.integers(1, 240, 52).tolist()
    base_b = rng.integers(1, 240, 66).tolist()
    (ra,) = run(warm, [base_a], 6)
    (rb,) = run(warm, [base_b], 6)
    prompt_a = base_a + ra.token_ids + rng.integers(1, 240, 5).tolist()
    prompt_b = base_b + rb.token_ids + rng.integers(1, 240, 9).tolist()
    got = run(warm, [prompt_a, prompt_b], 8)
    c = warm.perf_counters()
    assert c["prefix_cache_hits"] == 2 and c["prefix_cache_reused_tokens"] == 48 + 64, c
    assert c["prefill_extend_batches"] == 1, c
    want = run(make_engine(model, "paged", prefix_cache=False, **over), [prompt_a, prompt_b], 8)
    assert_same(got, want, 1e-5)


def test_auto_layout_is_slab_paged_is_opt_in(model):
    assert not make_engine(model, "auto").paged
    assert not make_engine(model, "auto", max_len=4096, prefill_buckets=(64, 128)).paged
    assert make_engine(model, "paged", max_len=4096, prefill_buckets=(64, 128), kv_pool_blocks=64).paged
    with pytest.raises(ValueError):
        make_engine(model, "blocks")


# ---------------------------------------------------------------------------
# launch.build_engine
# ---------------------------------------------------------------------------


def _built(overrides):
    cfg = compose("bandit_cpu", ["output_dir=/tmp/unused", *overrides])
    params, model_cfg, tokenizer = launch.build_model(cfg, device="cpu")
    return launch.build_engine(cfg, params, model_cfg, tokenizer, device="cpu")


def test_build_engine_builds_the_paged_layout():
    engine = _built(["engine.kv_layout=paged", "engine.kv_block_size=16", "engine.kv_pool_blocks=20"])
    assert engine.paged and engine.prefix_cache is not None
    assert (engine.block_pool.n_blocks, engine.block_pool.block_size) == (20, 16)
    assert tuple(engine.k_pool.shape[1:3]) == (20, 16)
    assert not _built(["engine.prefix_cache=false", "engine.kv_layout=paged"]).prefix_cache
    slab = _built([])
    assert not slab.paged and slab.cfg.kv_block_size == 128 and slab.cfg.prefix_cache


def test_build_engine_still_refuses_engine_tp():
    """One process cannot build a tp or a pp engine: ``engine.tp=2`` and
    ``engine.pp=2`` each run as two rank processes
    (``test_torch_engine_tp.py``, ``test_torch_engine_pp.py``), and
    ``build_engine`` without their world says so."""
    with pytest.raises(ValueError, match="engine.tp=2 runs as 2 engine rank processes"):
        _built(["engine.tp=2", "engine.kv_layout=paged"])
    with pytest.raises(ValueError, match="engine.pp=2 runs as 2 engine rank processes"):
        _built(["engine.pp=2", "engine.kv_layout=paged"])


def test_prefix_cache_never_reuses_an_unwritten_row(model):
    """At pipeline depth 1 a request whose budget ends on a window's last
    step never feeds its final token, so that token's K/V row is unwritten.
    With prompt + completion a whole number of pages (27 + 5 = 32), the
    registered transcript stops before that token: a later prompt reuses one
    page and matches a cold engine (registering the final token, as the JAX
    paged engine does, reuses two pages and gives other logprobs)."""
    rng = np.random.default_rng(0)
    for _ in range(3):
        prompt1 = rng.integers(1, 200, 27).tolist()
        warm = make_engine(model, "paged")
        (r1,) = run(warm, [prompt1], 5)
        prompt2 = prompt1 + r1.token_ids + rng.integers(1, 200, 6).tolist()
        (r2_warm,) = run(warm, [prompt2], 8)
        assert warm.perf_counters()["prefix_cache_reused_tokens"] == 16
        (r2_cold,) = run(make_engine(model, "paged", prefix_cache=False), [prompt2], 8)
        assert_same([r2_warm], [r2_cold], 1e-5)
