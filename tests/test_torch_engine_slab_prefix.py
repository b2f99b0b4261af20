"""Slab prefix parking on the port: the counterparts of
tests/test_engine_slab_prefix.py, each run on the port's slab engine and on
the JAX package's with the same fp32 weights (``params_from_numpy``). Greedy
tokens must be identical, and ``prefix_cache_hits``,
``prefill_reused_tokens`` and ``prefix_cache_parked_slots`` equal; a resumed
turn must give the tokens of a cold engine."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pipelinerl_tpu.inference import engine as je
from pipelinerl_tpu.models import transformer as jt
from pipelinerl_tpu_torch.inference import engine as te
from pipelinerl_tpu_torch.models import transformer as tt

torch.set_num_threads(1)
KW = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_layers=2, num_heads=4, num_kv_heads=2)
COUNTERS = ("prefix_cache_hits", "prefill_reused_tokens", "prefix_cache_parked_slots")


@pytest.fixture(scope="module")
def setup():
    """The JAX test's model (fp32, seed 0) in both packages."""
    jcfg = jt.ModelConfig(dtype=jnp.float32, **KW)
    jparams = jt.init_params(jax.random.key(0), jcfg)
    tcfg = tt.ModelConfig(dtype=torch.float32, **KW)
    return jparams, jcfg, tt.params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, "cpu"), tcfg


def engine_kw(prefix_cache, max_slots, **over):
    """The JAX test's engine (tests/test_engine_slab_prefix.py:32-43)."""
    return dict(max_slots=max_slots, max_len=256, prefill_buckets=(32, 64, 128, 192), decode_window=4,
                kv_layout="slab", prefix_cache=prefix_cache, slab_prefix_min_tokens=8) | over


class Pair:
    """The port's engine and the JAX package's, driven alike."""

    def __init__(self, setup, prefix_cache=True, max_slots=4, **over):
        jparams, jcfg, tparams, tcfg = setup
        kw = engine_kw(prefix_cache, max_slots, **over)
        self.t = te.InferenceEngine(tparams, tcfg, te.EngineConfig(cache_dtype=torch.float32, **kw),
                                    eos_token_id=-1, device="cpu")
        self.j = je.InferenceEngine(jparams, jcfg, je.EngineConfig(cache_dtype=jnp.float32, **kw),
                                    eos_token_id=-1)

    def run(self, prompts, max_tokens):
        """Greedy completions of ``prompts`` on both engines, which must
        agree token for token and on the prefix counters."""
        out = []
        for mod, engine in ((te, self.t), (je, self.j)):
            futures = [engine.submit(mod.GenRequest(list(p), mod.SamplingParams(temperature=0.0,
                                                                               max_tokens=max_tokens)))
                       for p in prompts]
            for _ in range(5000):
                if all(f.done() for f in futures):
                    break
                engine.step()
            out.append([f.result().token_ids for f in futures])
        assert out[0] == out[1]
        assert self.counters() == self.jax_counters()
        return out[0]

    def counters(self):
        c = self.t.perf_counters()
        return {k: c[k] for k in COUNTERS}

    def jax_counters(self):
        c = self.j.perf_counters()
        return {k: c[k] for k in COUNTERS}

    def stop(self):
        self.j.stop()


def test_resume_token_exact_at_window_boundary(setup):
    """max_tokens 9 = 1 + 2 W puts the final token on a window's last step,
    so its K/V row is never written; the parked transcript leaves it out,
    and the resumed turn gives the cold engine's tokens."""

    def two_turns(prefix_cache):
        rng = np.random.default_rng(7)
        base = rng.integers(1, 120, 40).tolist()
        pair = Pair(setup, prefix_cache)
        (first,) = pair.run([base], 9)
        (second,) = pair.run([base + first + rng.integers(1, 120, 10).tolist()], 9)
        c = pair.counters()
        pair.stop()
        return first, second, c

    cold1, cold2, _ = two_turns(False)
    warm1, warm2, c = two_turns(True)
    assert warm1 == cold1
    assert c == {"prefix_cache_hits": 1, "prefill_reused_tokens": 40 + 9 - 1, "prefix_cache_parked_slots": 1}
    assert warm2 == cold2, "resumed turn diverged (unwritten final-token row?)"


def test_multiturn_resumes_parked_slot(setup):
    rng = np.random.default_rng(0)
    base = rng.integers(1, 120, 40).tolist()
    cold = Pair(setup, prefix_cache=False)
    (f1,) = cold.run([base], 8)
    turn2 = base + f1 + rng.integers(1, 120, 10).tolist()
    (cold2,) = cold.run([turn2], 8)
    cold.stop()

    warm = Pair(setup, prefix_cache=True)
    assert warm.run([base], 8) == [f1]
    assert len(warm.t._parked) == 1 and warm.t._parked[0][0] == base + f1[:-1]
    before = warm.t.total_prefill_tokens
    assert warm.run([turn2], 8) == [cold2]
    assert warm.t.slab_prefix_hits == 1 and warm.t.prefill_extend_batches == 1
    # only the tail was prefilled: the final token of turn 1 and 10 new ones
    assert warm.t.total_prefill_tokens - before == 11
    assert warm.t.prefill_reused_tokens == len(base) + len(f1) - 1
    warm.stop()


def test_parked_slots_evicted_under_pressure(setup):
    """Parking never lowers concurrency: with every slot parked, unrelated
    prompts evict the least recently parked and admit at once."""
    rng = np.random.default_rng(1)
    pair = Pair(setup, prefix_cache=True, max_slots=2)
    pair.run([rng.integers(1, 120, 24).tolist() for _ in range(2)], 4)
    assert len(pair.t._parked) == 2
    stamps = sorted(pair.t._parked, key=lambda s: pair.t._parked[s][1])
    prompts = [rng.integers(1, 120, 24).tolist() for _ in range(4)]
    for mod, engine in ((te, pair.t), (je, pair.j)):
        for p in prompts[:1]:
            engine.submit(mod.GenRequest(p, mod.SamplingParams(temperature=0.0, max_tokens=4)))
        engine.step()
        assert engine.num_active == 1
    # the first admission evicted the older parked slot
    assert set(pair.t._parked) == set(pair.j._parked) == {stamps[1]}
    results = pair.run(prompts[1:], 4)
    assert all(len(r) == 4 for r in results)
    pair.stop()


def test_park_skips_short_transcripts(setup):
    pair = Pair(setup, prefix_cache=True)
    pair.run([[5, 6]], 2)  # 2 + 2 - 1 tokens < slab_prefix_min_tokens = 8
    assert len(pair.t._parked) == len(pair.j._parked) == 0
    pair.stop()


def test_multiturn_lineages_batch(setup):
    """Lineages advancing in lockstep hit their parked slots in one
    admission wave; the three tails extend in batches of 2 and 1."""
    rng = np.random.default_rng(2)
    pair = Pair(setup, prefix_cache=True, max_slots=4)
    bases = [rng.integers(1, 120, 30).tolist() for _ in range(3)]
    firsts = pair.run(bases, 6)
    assert len(pair.t._parked) == 3
    turn2 = [b + f + rng.integers(1, 120, 8).tolist() for b, f in zip(bases, firsts)]
    pair.run(turn2, 6)
    assert pair.counters()["prefix_cache_hits"] == 3
    assert pair.t.prefill_extend_batches == 2
    pair.stop()


def test_hit_whose_padded_tail_overruns_the_slot_prefills_cold(setup):
    """max_len 128 (T_alloc 132): a 103-token parked transcript and an
    11-token tail padded to 32 would write past the slot, so the hit falls
    back to a cold prefill in the parked slot and gives back its hit."""

    def two_turns(prefix_cache):
        rng = np.random.default_rng(4)
        base = rng.integers(1, 120, 64).tolist()
        pair = Pair(setup, prefix_cache, max_len=128, prefill_buckets=(32, 64, 128))
        (first,) = pair.run([base], 40)
        (second,) = pair.run([base + first + rng.integers(1, 120, 10).tolist()], 8)
        c, batches = pair.counters(), pair.t.prefill_extend_batches
        pair.stop()
        return first, second, c, batches

    cold1, cold2, _, _ = two_turns(False)
    warm1, warm2, c, batches = two_turns(True)
    assert (warm1, warm2) == (cold1, cold2)
    assert c == {"prefix_cache_hits": 0, "prefill_reused_tokens": 0, "prefix_cache_parked_slots": 1}
    assert batches == 0


def test_aborted_turn_parks_its_transcript_less_the_last_token(setup):
    """An abort finishes its slot directly (no early retirement), so the
    park entry is ``_finish_slot``'s: the transcript less its final token.
    The next turn, built on the aborted tokens, resumes the slot and gives
    the cold engine's tokens."""

    def two_turns(prefix_cache):
        rng = np.random.default_rng(9)
        base = rng.integers(1, 120, 40).tolist()
        pair = Pair(setup, prefix_cache)
        firsts = []
        for mod, engine in ((te, pair.t), (je, pair.j)):
            future = engine.submit(mod.GenRequest(list(base), mod.SamplingParams(temperature=0.0, max_tokens=60),
                                                  request_id="a"))
            for _ in range(4):
                engine.step()
            engine.abort("a")
            for _ in range(50):
                if future.done():
                    break
                engine.step()
            result = future.result()
            assert result.finish_reason == "abort"
            firsts.append(result.token_ids)
        assert firsts[0] == firsts[1] and len(firsts[0]) > 1
        parked = [e[0] for e in pair.t._parked.values()] if prefix_cache else []
        (second,) = pair.run([base + firsts[0] + rng.integers(1, 120, 10).tolist()], 8)
        c = pair.counters()
        pair.stop()
        return firsts[0], second, c, parked

    cold1, cold2, _, _ = two_turns(False)
    warm1, warm2, c, parked = two_turns(True)
    assert warm1 == cold1
    assert parked == [[*np.random.default_rng(9).integers(1, 120, 40).tolist(), *warm1[:-1]]]
    assert c["prefix_cache_hits"] == 1 and c["prefill_reused_tokens"] == 40 + len(warm1) - 1
    assert warm2 == cold2
