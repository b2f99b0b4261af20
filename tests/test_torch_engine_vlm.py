"""The port's VLM engine path against the JAX package's engine on the JAX
test's toy VLM (tests/test_engine_vlm.py), fp32 weights carried through
numpy: greedy tokens equal and logprobs within 1e-4 on the slab and the
paged layouts (a padded patch bucket, mrope decode deltas, text requests
beside the visual ones), a GRPO group of one image sharing one prefill, and
an engine with no tower refusing a visual request."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pipelinerl_tpu.inference import engine as je
from pipelinerl_tpu.models import transformer as jt
from pipelinerl_tpu.models import vision as jv
from pipelinerl_tpu_torch.inference import engine as te
from pipelinerl_tpu_torch.models import transformer as tt
from pipelinerl_tpu_torch.models import vision as tv

torch.set_num_threads(1)
IMG = 9
MKW = dict(vocab_size=64, hidden_size=32, intermediate_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
           mrope_section=(2, 1, 1), image_token_id=IMG)
VKW = dict(hidden_size=16, intermediate_size=32, num_heads=2, depth=2, out_hidden_size=32, patch_size=2,
           temporal_patch_size=1, spatial_merge_size=2, window_size=8, fullatt_block_indexes=(1,))
LP_ATOL = 1e-4  # fp32 logprobs, sums in another order on each side


@pytest.fixture(scope="module")
def models():
    jcfg, jvcfg = jt.ModelConfig(dtype=jnp.float32, **MKW), jv.VisionConfig(dtype=jnp.float32, **VKW)
    jparams = jt.init_params(jax.random.key(0), jcfg)
    jvparams = jv.init_vision_params(jax.random.key(1), jvcfg)
    tcfg, tvcfg = tt.ModelConfig(dtype=torch.float32, **MKW), tv.VisionConfig(dtype=torch.float32, **VKW)
    tparams = tt.params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    tvparams = tt.params_from_numpy(jax.tree.map(np.asarray, jvparams), tcfg, "cpu")
    return (jparams, jcfg, jvparams, jvcfg), (tparams, tcfg, tvparams, tvcfg)


def image(grid, seed):
    rng = np.random.default_rng(seed)
    return {"pixel_values": rng.normal(size=(int(np.prod(grid)), 12)).astype(np.float32) * 0.5,
            "image_grid_thw": np.asarray([grid])}


def engine_kw(layout, **over):
    kw = dict(max_slots=6, max_len=64, prefill_buckets=(16, 32), decode_window=4, window_pipeline_depth=1,
              vision_unit_buckets=(8, 16), kv_layout=layout, kv_block_size=8)
    kw.update(over)
    return kw


def engines(models, layout, tower=True, **over):
    (jparams, jcfg, jvparams, jvcfg), (tparams, tcfg, tvparams, tvcfg) = models
    j = je.InferenceEngine(jparams, jcfg, je.EngineConfig(cache_dtype=jnp.float32, **engine_kw(layout, **over)),
                           eos_token_id=-1, vision_params=jvparams if tower else None,
                           vision_cfg=jvcfg if tower else None)
    t = te.InferenceEngine(tparams, tcfg, te.EngineConfig(cache_dtype=torch.float32, **engine_kw(layout, **over)),
                           eos_token_id=-1, device="cpu", vision_params=tvparams if tower else None,
                           vision_cfg=tvcfg if tower else None)
    return j, t


def requests(cls, specs, max_tokens=12):
    return [cls.GenRequest(list(ids), cls.SamplingParams(temperature=0.0, max_tokens=max_tokens), visual=vis)
            for ids, vis in specs]


def drain(engine, futures):
    for _ in range(3000):
        engine.step()
        if all(f.done() for f in futures):
            return [f.result() for f in futures]
    raise TimeoutError("engine did not finish")


SPECS = [
    ([5, 6, IMG, IMG, IMG, IMG, 7], image((1, 4, 4), 2)),  # 4 merged tokens in a bucket of 8
    ([3] + [IMG] * 6 + [4, 5, 6], image((1, 4, 6), 3)),
    ([1, 2] + [IMG] * 9 + [8], image((1, 6, 6), 4)),  # 9 tokens: the bucket of 16
    ([7, 8, 9, 10], None),  # text beside them
]


@pytest.mark.parametrize("layout", ["slab", "paged"])
def test_vlm_greedy_equals_jax_engine(models, layout):
    j, t = engines(models, layout)
    want = drain(j, [j.submit(r) for r in requests(je, SPECS)])
    got = drain(t, [t.submit(r) for r in requests(te, SPECS)])
    for g, w in zip(got, want):
        assert g.token_ids == w.token_ids, (g.token_ids, w.token_ids)
        assert g.finish_reason == w.finish_reason
        np.testing.assert_allclose(g.logprobs, w.logprobs, rtol=0, atol=LP_ATOL)
    # a VLM slot's decode positions carry its mrope delta (max position + 1 - prompt length)
    assert t._pos_delta.tolist() == j._pos_delta.tolist()
    if layout == "paged":
        t.block_pool.check_invariants()
    j.stop()
    t.stop()


@pytest.mark.parametrize("layout", ["slab", "paged"])
def test_vlm_group_forks_share_one_prefill(models, layout):
    """Three requests of one prompt and one image prefill once; the
    siblings fork the KV, and greedy continuations agree with JAX's."""
    spec = SPECS[0]
    j, t = engines(models, layout)
    want = drain(j, [j.submit(r) for r in requests(je, [spec] * 3, 6)])
    got = drain(t, [t.submit(r) for r in requests(te, [spec] * 3, 6)])
    assert [g.token_ids for g in got] == [w.token_ids for w in want]
    assert got[0].token_ids == got[1].token_ids == got[2].token_ids
    assert t.prefill_batches == 1 and t.prefill_reused_tokens == 2 * len(spec[0]) == j.prefill_reused_tokens
    # another image with the same prompt is its own cluster
    other = (spec[0], image((1, 4, 4), 9))
    t2 = engines(models, layout)[1]
    drain(t2, [t2.submit(r) for r in requests(te, [spec, other], 6)])
    assert t2.prefill_batches == 2 and t2.prefill_reused_tokens == 0
    for e in (j, t, t2):
        e.stop()


def test_engine_without_tower_refuses_a_visual_request(models):
    j, t = engines(models, "slab", tower=False)
    req = requests(te, [SPECS[0]])[0]
    fut = t.submit(req)
    with pytest.raises(RuntimeError, match="no vision tower"):
        fut.result(timeout=5)
    jfut = j.submit(requests(je, [SPECS[0]])[0])
    for _ in range(20):
        j.step()
        if jfut.done():
            break
    with pytest.raises(RuntimeError, match="no vision tower"):
        jfut.result()
    # text still serves
    assert drain(t, [t.submit(requests(te, [SPECS[3]])[0])])[0].token_ids
    j.stop()
    t.stop()


def test_visual_slots_are_never_parked_or_cached(models):
    """A VLM transcript's KV depends on its pixels: a finished visual slot
    is neither parked (slab) nor registered in the prefix cache (paged), as
    in the JAX engine."""
    for layout in ("slab", "paged"):
        _, t = engines(models, layout, slab_prefix_min_tokens=4)
        drain(t, [t.submit(r) for r in requests(te, SPECS[:2], 4)])
        if layout == "slab":
            assert not t._parked
        else:
            assert t.prefix_cache.pages_held == 0
        t.stop()
