"""Pushes over the double-buffer budget on the port's engine, against the
JAX package's engine: the leaf-streamed host tree
(tests/test_engine.py::test_leaf_streamed_host_push_for_oversize_trees), the
chunked PWT3 body (tests/test_weight_transfer.py's blob and blob-chunked
cases), and the row splice of one tensor larger than a chunk. In each case
the mode names equal JAX's, the leaves equal the pushed arrays bit for bit,
and greedy continuations on the new weights equal the JAX engine's. A newer
push cuts a chunked stream short and wins, leaving a mixed tree with no
version bump; an older one never cuts it. A body that carries
``vision_tower/*`` refreshes an engine's tower piece by piece."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pipelinerl_tpu.inference import engine as je
from pipelinerl_tpu.inference import weight_transfer as jwt
from pipelinerl_tpu.models import transformer as jt
from pipelinerl_tpu.models import vision as jv
from pipelinerl_tpu_torch.inference import engine as te
from pipelinerl_tpu_torch.inference import weight_transfer as twt
from pipelinerl_tpu_torch.inference.server import InferenceServer
from pipelinerl_tpu_torch.models import transformer as tt
from pipelinerl_tpu_torch.models import vision as tv
from tests.test_torch_weight_transfer import DTYPES, KW, assert_same_bits, numpy_tree, to_torch

torch.set_num_threads(1)
PROMPTS = [[5, 7, 9], [3, 1, 4, 1, 5, 9, 2, 6]]
# chunk sizes: above every tensor (tensors grouped into pieces, no row
# splice), and below the embedding (embed [32, 32] is 4 KB in f32, 2 KB in
# bf16; it goes by rows, as the stacked [2, 32, 64] MLP weights do)
CHUNKS = {"grouped": 16384, "row_splice": 1024}


def engine_kw(budget: int, chunk: int) -> dict:
    return dict(max_slots=2, max_len=64, prefill_buckets=(16,), decode_window=4, window_pipeline_depth=1,
                push_double_buffer_max_bytes=budget, push_stream_chunk_bytes=chunk)


def engines(dtype: str, budget: int, chunk: int, start_seed: int = 0):
    start = numpy_tree(start_seed, dtype)
    jcfg, tcfg = jt.ModelConfig(dtype=DTYPES[dtype][0], **KW), tt.ModelConfig(dtype=DTYPES[dtype][1], **KW)
    j = je.InferenceEngine(jax.tree.map(jnp.asarray, start), jcfg,
                           je.EngineConfig(cache_dtype=jnp.float32, **engine_kw(budget, chunk)), eos_token_id=0)
    t = te.InferenceEngine(to_torch(start), tcfg, te.EngineConfig(cache_dtype=torch.float32,
                                                                  **engine_kw(budget, chunk)),
                           eos_token_id=0, device="cpu")
    return j, t


def wait(engine, version, futures=(), timeout=60.0):
    import time

    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        engine.step()
        if engine.version == version and all(f.done() for f in futures):
            return
        time.sleep(0.002)
    raise AssertionError(f"engine at v{engine.version}, expected v{version}")


def greedy(engine, cls, n=12):
    futs = [engine.submit(cls.GenRequest(list(p), cls.SamplingParams(temperature=0.0, max_tokens=n)))
            for p in PROMPTS]
    for _ in range(3000):
        engine.step()
        if all(f.done() for f in futs):
            return [f.result().token_ids for f in futs]
    raise TimeoutError


def test_leaf_streamed_host_push_for_oversize_trees():
    """A host tree of numpy arrays over the budget (0 here) streams leaf by
    leaf into the live weights while a request decodes: mode "streamed" in
    both packages, the version lands, the in-flight request finishes, the
    leaves equal the pushed arrays, and greedy continuations on them equal
    the JAX engine's."""
    new = numpy_tree(1, "float32")
    j, t = engines("float32", 0, CHUNKS["grouped"])
    futs = []
    for engine, cls in ((j, je), (t, te)):
        fut = engine.submit(cls.GenRequest([5, 7, 9], cls.SamplingParams(temperature=0.0, max_tokens=20)))
        engine.step()
        engine.update_params(jax.tree.map(np.copy, new), version=4)
        wait(engine, 4, [fut])
        futs.append(fut)
        assert engine.last_push_timings["mode"] == "streamed"
    res = futs[1].result()
    assert res.finish_reason in ("stop", "length") and res.model_version_end == 4 and res.token_ids
    assert_same_bits(t.params, new)
    assert greedy(t, te) == greedy(j, je)
    assert t.push_counters()["pushes_completed"] == 1
    j.stop()
    t.stop()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunks", list(CHUNKS))
@pytest.mark.parametrize("budget", [1 << 30, 1024])
def test_pwt3_push_modes_equal_jax(dtype, chunks, budget):
    """One PWT3 body (with a trainer-only value head) into both engines:
    within the budget "blob", over it "blob-chunked" in both; every leaf
    equals the body bit for bit, the value head is dropped; greedy
    continuations on the new weights equal JAX's. Under the small chunk
    the embedding is row-spliced."""
    new = numpy_tree(2, dtype)
    body = bytes(twt.serialize_params(to_torch({**new, "value_head": {"w": np.ones(4, np.float32)}}), version=11))
    j, t = engines(dtype, budget, CHUNKS[chunks])
    snapshots = []
    yielded = t._should_yield_to_newer
    t._should_yield_to_newer = lambda v: (snapshots.append(dict(t.last_push_timings)), yielded(v))[1]
    for engine in (j, t):
        assert engine.update_params_serialized(body) == 11
        wait(engine, 11)
    assert t.last_push_timings["mode"] == j.last_push_timings["mode"] == ("blob" if budget > 1024 else "blob-chunked")
    assert_same_bits(t.params, new)
    assert_same_bits(jax.tree.map(np.asarray, j.params), new)
    if budget == 1024:
        spliced = t.last_push_timings["row_spliced"]
        assert ("embed" in spliced) == (chunks == "row_splice")
        # progress after each piece: bytes_done grows to the push's size
        done = [s["bytes_done"] for s in snapshots if s.get("in_progress")]
        assert done == sorted(done) and done[-1] == t.last_push_timings["bytes"] and len(done) > 1
        assert all(s["mode"] == "blob-chunked" for s in snapshots)
    assert greedy(t, te) == greedy(j, je)
    j.stop()
    t.stop()


def test_plan_pieces_bound_each_piece():
    """Pieces hold whole tensors up to the chunk, a larger tensor goes by
    whole rows, and together they cover every element once."""
    _, t = engines("float32", 0, 3000)
    shapes = [("a", (10,), 0), ("b", (4, 100), 10), ("c", (7, 3), 410), ("d", (2, 2000), 431), ("e", (5,), 4431)]
    pieces = t._plan_pieces(shapes, 4)
    covered = np.zeros(4436, np.int32)
    for lo, hi, targets in pieces:
        covered[lo:hi] += 1
        assert (hi - lo) * 4 <= 3000 or (len(targets) == 1 and targets[0][2] == 1)
    assert (covered == 1).all()
    rows = [(name, row, n) for _, _, targets in pieces for name, row, n, _ in targets if row is not None]
    assert rows == [("d", 0, 1), ("d", 1, 1)]  # b fits a piece whole; a row of d is larger than one
    t.stop()


def test_a_newer_push_cuts_a_chunked_stream_and_an_older_one_never_does():
    """A newer push waiting when a piece lands cuts the stream short: the
    pieces already in stay (a mixed tree), the version does not move, and
    the newer push then lands whole. An older one waiting never cuts it."""
    start, mid, new = numpy_tree(0, "float32"), numpy_tree(3, "float32"), numpy_tree(4, "float32")
    _, t = engines("float32", 1024, CHUNKS["row_splice"])
    groups, tensors, _, base = twt.parse_push_header(bytes(twt.serialize_params(to_torch(mid), version=5)))
    body = bytes(twt.serialize_params(to_torch(mid), version=5))
    newer = ("blob", b"", [], [], 0, 9)
    t._transfer_pending = newer
    t._transfer_blob(body, groups, tensors, base, 5)
    got = dict(twt.flatten_params(t.params))
    same_mid = [n for n, w in twt.flatten_params(mid) if np.array_equal(got[n].numpy(), w)]
    same_start = [n for n, w in twt.flatten_params(start) if np.array_equal(got[n].numpy(), w)]
    assert t.version == 0 and t.push_counters()["pushes_superseded"] == 1
    assert same_mid and same_start, "the cut stream leaves a mixed tree"
    assert "mode" in t.last_push_timings and t.last_push_timings["in_progress"]
    # the newer push lands whole
    t._transfer_pending = None
    t.update_params_serialized(bytes(twt.serialize_params(to_torch(new), version=9)))
    wait(t, 9)
    assert_same_bits(t.params, new)
    # an older push waiting behind a stream in flight does not cut it
    t._transfer_pending = ("blob", b"", [], [], 0, 3)
    t._transfer_blob(body, groups, tensors, base, 12)
    assert t.version == 12 and t.push_counters()["pushes_superseded"] == 1
    assert_same_bits(t.params, mid)
    t.stop()


def test_streamed_pushes_refresh_the_tower_and_health_reports_them():
    """A body that carries ``vision_tower/*`` is accepted by an engine with
    a tower (chunked: the tower's leaves are spliced in place), dropped by
    one without, and rejected when its tower does not match; ``/health``'s
    ``last_push`` names the mode."""
    IMG = 9
    mkw = dict(vocab_size=64, hidden_size=32, intermediate_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
               mrope_section=(2, 1, 1), image_token_id=IMG)
    vkw = dict(hidden_size=16, intermediate_size=32, num_heads=2, depth=2, out_hidden_size=32, patch_size=2,
               temporal_patch_size=1, spatial_merge_size=2, window_size=8, fullatt_block_indexes=(1,))
    jcfg, jvcfg = jt.ModelConfig(dtype=jnp.float32, **mkw), jv.VisionConfig(dtype=jnp.float32, **vkw)
    tcfg, tvcfg = tt.ModelConfig(dtype=torch.float32, **mkw), tv.VisionConfig(dtype=torch.float32, **vkw)
    params = jax.tree.map(np.asarray, jt.init_params(jax.random.key(0), jcfg))
    tower = jax.tree.map(np.asarray, jv.init_vision_params(jax.random.key(1), jvcfg))
    new = jax.tree.map(np.asarray, jt.init_params(jax.random.key(5), jcfg))
    new_tower = jax.tree.map(np.asarray, jv.init_vision_params(jax.random.key(6), jvcfg))
    body = bytes(jwt.serialize_params({**new, "vision_tower": new_tower}, version=3))

    def engine(with_tower, **kw):
        return te.InferenceEngine(tt.params_from_numpy(params, tcfg, "cpu"), tcfg,
                                  te.EngineConfig(max_slots=2, max_len=64, prefill_buckets=(32,),
                                                  cache_dtype=torch.float32, **kw),
                                  eos_token_id=0, device="cpu",
                                  vision_params=tt.params_from_numpy(tower, tcfg, "cpu") if with_tower else None,
                                  vision_cfg=tvcfg if with_tower else None)

    for kw, mode in (({}, "blob"), ({"push_double_buffer_max_bytes": 1024, "push_stream_chunk_bytes": 2048},
                                   "blob-chunked")):
        e = engine(True, **kw)
        e.update_params_serialized(body)
        wait(e, 3)
        assert_same_bits(e.params, new)
        assert_same_bits(e.vision_params, new_tower)
        assert InferenceServer(e, None).health()["last_push"]["mode"] == mode
        assert set(InferenceServer(e, None).checksums()["checksums"]) == {
            n for n, _ in twt.flatten_params({**new, "vision_tower": new_tower})}
        e.stop()
    e = engine(False)
    e.update_params_serialized(body)
    wait(e, 3)
    assert_same_bits(e.params, new) and e.vision_params is None
    e.stop()
    e = engine(True)
    bad = {**new, "vision_tower": {**new_tower, "patch_embed": np.zeros((3, 16), np.float32)}}
    with pytest.raises(ValueError, match="vision_tower/patch_embed"):
        e.update_params_serialized(bytes(jwt.serialize_params(bad, version=4)))
    e.stop()
