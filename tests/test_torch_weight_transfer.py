"""The port's PWT3 weight pushes against the JAX package's: the same bytes
from the same tree (fp32 and bf16), a header codec equal to msgpack, bodies
that land bit for bit across the two packages in both directions, and the
port's counterparts of tests/test_weight_transfer.py (a mismatched tree is
rejected, rapid pushes converge, a sustained supersede completes, a push
over the double-buffer budget streams in as the JAX engine's does)."""

import time

import msgpack
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp
import torch

from pipelinerl_tpu.inference import engine as je
from pipelinerl_tpu.inference import weight_transfer as jwt
from pipelinerl_tpu.models import transformer as jt
from pipelinerl_tpu_torch.inference import engine as te
from pipelinerl_tpu_torch.inference import weight_transfer as twt
from pipelinerl_tpu_torch.models import transformer as tt

torch.set_num_threads(1)
KW = dict(vocab_size=32, hidden_size=32, intermediate_size=64, num_layers=2, num_heads=2, num_kv_heads=2)
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def numpy_tree(seed: int, dtype: str) -> dict:
    jcfg = jt.ModelConfig(dtype=DTYPES[dtype][0], **KW)
    return jax.tree.map(np.asarray, jt.init_params(jax.random.key(seed), jcfg))


def to_torch(tree):
    """numpy leaves (bf16 from ml_dtypes) → torch CPU tensors, bit for bit."""
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    if tree.dtype.name == "bfloat16":
        return torch.from_numpy(tree.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(tree.copy())


def bits(x) -> np.ndarray:
    """A leaf's raw bits as unsigned integers, for either package."""
    if isinstance(x, torch.Tensor):
        x = x.detach().contiguous()
        return x.view(torch.int16 if x.element_size() == 2 else torch.int32).numpy().view(
            np.uint16 if x.element_size() == 2 else np.uint32)
    x = np.asarray(x)
    return x.view(np.uint16 if x.dtype.itemsize == 2 else np.uint32)


def assert_same_bits(got: dict, want: dict) -> None:
    g, w = dict(twt.flatten_params(got)), dict(twt.flatten_params(want))
    assert set(g) == set(w)
    for name in w:
        np.testing.assert_array_equal(bits(g[name]), bits(w[name]), err_msg=name)


def port_engine(params, dtype=torch.float32, **kw):
    cfg = tt.ModelConfig(dtype=dtype, **KW)
    base = dict(max_slots=2, max_len=32, prefill_buckets=(16,), cache_dtype=torch.float32)
    base.update(kw)
    return te.InferenceEngine(params, cfg, te.EngineConfig(**base), eos_token_id=0, device="cpu")


def wait_version(engine, version, timeout=30.0) -> None:
    deadline = time.monotonic() + timeout
    while engine.version != version and time.monotonic() < deadline:
        engine.step()
        time.sleep(0.002)
    assert engine.version == version, f"engine at v{engine.version}, expected v{version}"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_serialize_bytes_equal_jax(dtype):
    tree = numpy_tree(0, dtype)
    # a second dtype group and an int leaf, so groups sort as JAX sorts them
    tree = {**tree, "extra": {"counts": np.arange(5, dtype=np.int32), "scale": np.float32([1.5, -2.0])}}
    want = jwt.serialize_params(tree, version=7)
    got = twt.serialize_params(to_torch(tree), version=7)
    assert bytes(got) == want
    restored, version = twt.deserialize_params(want)
    assert version == 7
    assert_same_bits(restored, tree)


@st.composite
def header_like(draw):
    """Dicts shaped like PWT3 headers, with sizes that cross msgpack's
    encoding boundaries (fixstr/str8, fixarray/array16, fixint/uint/int)."""
    ints = st.integers(min_value=-(1 << 63), max_value=(1 << 64) - 1)
    names = st.text(min_size=0, max_size=300)
    tensor = st.fixed_dictionaries({
        "name": names, "dtype": st.sampled_from(["bfloat16", "float32", "int32"]),
        "shape": st.lists(st.integers(min_value=0, max_value=1 << 40), max_size=4), "elem_offset": ints,
    })
    group = st.fixed_dictionaries({"dtype": names, "byte_offset": ints, "count": ints})
    return {"version": draw(ints), "groups": draw(st.lists(group, max_size=3)),
            "tensors": draw(st.lists(tensor, max_size=20)),
            **draw(st.dictionaries(names, st.one_of(ints, names, st.booleans(), st.none()), max_size=17))}


@settings(max_examples=150, deadline=None)
@given(header_like())
def test_header_codec_equals_msgpack(header):
    packed = msgpack.packb(header)
    assert twt.packb(header) == packed
    assert twt.unpackb(packed) == msgpack.unpackb(packed, raw=False)


@pytest.fixture
def small_chunks(monkeypatch):
    monkeypatch.setattr(te, "PUSH_CHUNK_BYTES", 64)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jax_body_lands_in_port_engine(dtype, small_chunks):
    """A body made by the JAX package, staged chunk by chunk (64-byte
    chunks) through the port's transfer thread."""
    start, new = numpy_tree(0, dtype), numpy_tree(5, dtype)
    engine = port_engine(to_torch(start), DTYPES[dtype][1])
    body = jwt.serialize_params({**new, "value_head": {"w": np.ones(4, np.float32)}}, version=11)
    assert engine.update_params_serialized(body) == 11
    wait_version(engine, 11)
    assert_same_bits(engine.params, new)  # the value head is the trainer's and is dropped
    assert engine.last_push_timings["mode"] == "blob"
    assert engine.push_counters()["push_last_version"] == 11
    engine.stop()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_body_lands_in_jax_engine(dtype):
    jcfg = jt.ModelConfig(dtype=DTYPES[dtype][0], **KW)
    j_engine = je.InferenceEngine(
        jt.init_params(jax.random.key(0), jcfg), jcfg,
        je.EngineConfig(max_slots=2, max_len=32, prefill_buckets=(16,), cache_dtype=jnp.float32),
        eos_token_id=0,
    )
    new = numpy_tree(3, dtype)
    assert j_engine.update_params_serialized(bytes(twt.serialize_params(to_torch(new), version=4))) == 4
    wait_version(j_engine, 4)
    assert_same_bits(j_engine.params, new)
    j_engine.stop()


def test_numpy_tree_goes_through_the_transfer_thread(small_chunks):
    new = numpy_tree(2, "float32")
    engine = port_engine(to_torch(numpy_tree(0, "float32")))
    engine.update_params(new, 3)
    wait_version(engine, 3)
    assert engine.last_push_timings["mode"] == "double-buffer"
    assert all(isinstance(t, torch.Tensor) for _, t in twt.flatten_params(engine.params))
    assert_same_bits(engine.params, new)
    engine.stop()


def test_mismatched_push_rejected():
    engine = port_engine(to_torch(numpy_tree(0, "float32")))
    other = jax.tree.map(np.asarray, jt.init_params(
        jax.random.key(9), jt.ModelConfig(vocab_size=64, hidden_size=16, intermediate_size=32, num_layers=1,
                                          num_heads=2, num_kv_heads=2, dtype=jnp.float32)))
    with pytest.raises(ValueError, match="mismatch"):
        engine.update_params_serialized(twt.serialize_params(to_torch(other), version=5))
    wrong_dtype = numpy_tree(0, "bfloat16")
    with pytest.raises(ValueError, match="mismatch"):
        engine.update_params_serialized(jwt.serialize_params(wrong_dtype, version=5))
    assert engine.version == 0 and engine.push_counters()["pushes_received"] == 0
    engine.stop()


def slowed(engine, seconds: float):
    """Slow every staged chunk (here one per dtype group, the default chunk
    being larger than the tree), as the JAX tests slow ``_gated_put``."""
    orig = engine._copy_chunk

    def slow(dst, src):
        time.sleep(seconds)
        orig(dst, src)

    engine._copy_chunk = slow
    return engine


def bodies(versions, scale=0.01):
    base = numpy_tree(0, "float32")
    return [twt.serialize_params(to_torch(jax.tree.map(lambda x, v=v: x + scale * v, base)), version=v)
            for v in versions]


def test_rapid_pushes_converge():
    """Pushes arriving faster than the (slowed) transfer: the engine still
    reaches the latest version, never regressing (latest wins, one yield in
    a row)."""
    engine = slowed(port_engine(to_torch(numpy_tree(0, "float32"))), 0.05)
    pushed = bodies(range(1, 7))
    for body in pushed:
        engine.update_params_serialized(body)
        time.sleep(0.01)
    deadline, seen = time.monotonic() + 30, engine.version
    while engine.version != 6 and time.monotonic() < deadline:
        engine.step()
        assert engine.version >= seen, "version must never regress"
        seen = engine.version
        time.sleep(0.002)
    assert engine.version == 6, f"stuck at v{engine.version}"
    c = engine.push_counters()
    assert c["pushes_received"] == 6 and c["pushes_completed"] >= 1 and c["push_last_span_s"] > 0
    assert c["push_span_vs_update_interval"] is not None
    assert_same_bits(engine.params, twt.deserialize_params(pushed[-1])[0])
    engine.stop()


def test_sustained_supersede_still_completes():
    """A new push every 80 ms against a 30 ms transfer, with the engine on
    its own thread as it runs in a server: every second transfer at least
    completes, so the version advances instead of starving. (A test loop
    that spins ``step`` holds the GIL between the transfer thread's torch
    calls and stretches each transfer several times over; the engine's own
    loop waits when idle.)"""
    engine = slowed(port_engine(to_torch(numpy_tree(0, "float32"))), 0.03)
    pushed = bodies(range(1, 13), scale=0.001)
    engine.start()
    for body in pushed:
        engine.update_params_serialized(body)
        time.sleep(0.08)
    deadline = time.monotonic() + 30
    while engine.version < 11 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert engine.version >= 11, f"engine stuck at v{engine.version} after 12 pushes"
    c = engine.push_counters()
    assert c["pushes_completed"] >= 12 // 3
    assert c["pushes_superseded"] <= c["pushes_completed"] + 1  # never two yields in a row
    engine.stop()


@pytest.mark.parametrize("order", [(5, 4), (3, 5, 4)])
def test_a_push_queued_out_of_version_order_does_not_displace_a_newer_one(order):
    """Two bodies read at once can reach the engine out of version order (a
    server reads them on two threads). The newest version lands and stays:
    one in flight does not yield to an older one queued behind it, and an
    older one does not replace a newer one waiting in the queue."""
    engine = slowed(port_engine(to_torch(numpy_tree(0, "float32"))), 0.05)
    pushed = dict(zip(order, bodies(order)))
    engine.start()
    for body in pushed.values():
        engine.update_params_serialized(body)
        time.sleep(0.01)
    deadline = time.monotonic() + 30
    while engine.version < 5 and time.monotonic() < deadline:
        time.sleep(0.01)
    time.sleep(0.3)  # an older staged tree, if any, has had its chance to land
    assert engine.version == 5
    assert_same_bits(engine.params, twt.deserialize_params(pushed[5])[0])
    engine.stop()


@pytest.mark.parametrize("order", [(5, 4), (3, 5, 4)])
def test_an_older_push_queued_behind_a_newer_one_is_never_staged(order):
    """A push older than one that has landed is dropped before its
    transfer: staging it would copy a whole tree only to drop it at the
    swap, while the newer tree waits beside it on the device."""
    engine = slowed(port_engine(to_torch(numpy_tree(0, "float32"))), 0.05)
    staged, blob = [], engine._transfer_blob
    engine._transfer_blob = lambda *a: (staged.append(a[-1]), blob(*a))
    engine.start()
    for body in bodies(order):
        engine.update_params_serialized(body)
        time.sleep(0.01)
    deadline = time.monotonic() + 30
    while engine.version < 5 and time.monotonic() < deadline:
        time.sleep(0.01)
    time.sleep(0.3)  # the older push, if it were staged, has been taken by now
    assert engine.version == 5 and 4 not in staged, staged
    engine.stop()


def test_push_over_budget_raises():
    """Over the double-buffer budget both paths stream into the live weights
    as the JAX engine's do (the refusal this test held until the streamed
    push was ported): a body goes "blob-chunked", a host tree "streamed", each
    landing bit for bit and naming its mode as the JAX engine names it."""
    tree, new = numpy_tree(0, "float32"), numpy_tree(6, "float32")
    engine = port_engine(to_torch(tree), push_double_buffer_max_bytes=1024)
    jengine = je.InferenceEngine(jax.tree.map(jnp.asarray, tree), jt.ModelConfig(dtype=jnp.float32, **KW),
                                 je.EngineConfig(max_slots=2, max_len=32, prefill_buckets=(16,),
                                                 cache_dtype=jnp.float32, push_double_buffer_max_bytes=1024),
                                 eos_token_id=0)
    body = bytes(twt.serialize_params(to_torch(new), version=1))
    for e in (engine, jengine):
        assert e.update_params_serialized(body) == 1
        wait_version(e, 1)
    assert engine.last_push_timings["mode"] == jengine.last_push_timings["mode"] == "blob-chunked"
    assert_same_bits(engine.params, new)
    for e in (engine, jengine):
        e.update_params(tree, 2)
        wait_version(e, 2)
    assert engine.last_push_timings["mode"] == jengine.last_push_timings["mode"] == "streamed"
    assert_same_bits(engine.params, tree)
    assert engine.push_counters()["pushes_received"] == 2
    engine.stop()
    jengine.stop()


def test_device_tensors_swap_directly():
    """A tree of tensors on the engine's device skips the transfer thread,
    as the in-process trainer's swaps always have."""
    engine = port_engine(to_torch(numpy_tree(0, "float32")))
    new = to_torch(numpy_tree(4, "float32"))
    engine.update_params(new, 2)
    engine.step()
    assert engine.version == 2 and engine.params is new
    assert engine.push_counters()["pushes_received"] == 0
    engine.stop()
