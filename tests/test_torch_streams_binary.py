"""The port's binary streams against the JAX package's: the port's msgpack
encoder writes ``msgpack.packb``'s bytes (hypothesis-made messages, numpy
arrays among them) and its decoder reads them as ``msgpack.unpackb`` does;
``.scf`` files written by either package read in the other, byte for byte
the same file; a torn tail waits for the writer, and a bad magic or a CRC
mismatch raises ``OSError(EBADMSG)`` in both."""

import errno
import struct
import zlib

import msgpack
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from pipelinerl_tpu import streams as j_streams
from pipelinerl_tpu import streams_binary as j_bin
from pipelinerl_tpu_torch import streams as t_streams
from pipelinerl_tpu_torch import streams_binary as t_bin
from pipelinerl_tpu_torch.utils import msgpack_codec

# the JSON-like values the streams carry, at every msgpack size class
scalars = (st.none() | st.booleans() | st.integers(-(2**63), 2**64 - 1)
           | st.floats(allow_nan=False) | st.text(max_size=300) | st.binary(max_size=300))
keys = st.text(max_size=40).filter(lambda k: k != "__nd__")
values = st.recursive(scalars, lambda kids: st.lists(kids, max_size=20) | st.dictionaries(keys, kids, max_size=20),
                      max_leaves=60)
DTYPES = ["<i4", "<i8", "<f4", "<f8", "|u1", "|b1", "<f2"]
arrays = st.builds(lambda dt, shape, seed: np.random.default_rng(seed).integers(0, 100, shape).astype(dt),
                   st.sampled_from(DTYPES), st.lists(st.integers(0, 5), max_size=3), st.integers(0, 2**16))


@settings(max_examples=150, deadline=None)
@given(values)
def test_msgpack_bytes_equal_packb(value):
    packed = msgpack.packb(value, use_bin_type=True)
    assert msgpack_codec.packb(value) == packed
    assert msgpack_codec.unpackb(packed) == msgpack.unpackb(packed, raw=False, strict_map_key=False)


@settings(max_examples=60, deadline=None)
@given(st.dictionaries(st.text(max_size=10), values | arrays, max_size=8), st.integers(-(2**31), 2**31),
       st.floats(width=32, allow_nan=False))
def test_stream_payloads_equal_jax(msg, n, x):
    msg = {**msg, "n": np.int64(n), "x": np.float32(x), "ids": np.arange(n % 50, dtype=np.int32)}
    payload = t_bin.encode(msg)
    assert payload == j_bin.encode(msg)
    for got in (t_bin.decode(payload), j_bin.decode(payload)):
        assert got.keys() == msg.keys()
        for key, want in msg.items():
            if isinstance(want, np.ndarray):
                assert got[key].dtype == want.dtype and got[key].shape == want.shape
                np.testing.assert_array_equal(got[key], want)
    assert t_bin.decode(payload)["n"] == n


def test_numpy_scalars_and_unknown_types():
    msg = {"a": np.int32(-3), "b": np.float64(0.25), "c": np.uint8(200)}
    assert t_bin.encode(msg) == j_bin.encode(msg) == msgpack.packb({"a": -3, "b": 0.25, "c": 200})
    for encode in (t_bin.encode, j_bin.encode):
        with pytest.raises(TypeError):
            encode({"x": object()})
    with pytest.raises(OverflowError):
        msgpack_codec.packb(2**64)


MESSAGES = [{"i": i, "ids": np.arange(i * 7, dtype=np.int32), "f": np.linspace(0, 1, 6, dtype=np.float32).reshape(2, 3),
             "nested": {"s": "héllo", "l": [1, 2.5, None, True]}} for i in range(6)]


def _equal(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for key in a:
        if isinstance(a[key], np.ndarray):
            np.testing.assert_array_equal(a[key], b[key])
            assert a[key].dtype == b[key].dtype
        else:
            assert a[key] == b[key]


@pytest.mark.parametrize("writer_pkg", ["jax", "port"])
def test_scf_files_cross_packages(tmp_path, writer_pkg):
    """Each package's writer, then both readers, through their stream
    classes (``binary`` backend); the files are the same bytes."""
    files = {}
    for pkg, mod in (("jax", j_streams), ("port", t_streams)):
        spec = mod.SingleStreamSpec(str(tmp_path / pkg), "bin")
        with mod.StreamWriter(spec, "binary") as w:
            for m in MESSAGES:
                w.write(m)
        files[pkg] = mod.stream_file_path(spec, "binary")
    assert files["jax"].read_bytes() == files["port"].read_bytes()
    path = files[writer_pkg]
    for mod in (j_streams, t_streams):
        exp = str(path.parents[3])
        reader = mod.StreamReader(mod.SingleStreamSpec(exp, "bin"), "binary")
        got = list(reader.read_available(max_messages=2)) + list(reader.read_available())
        assert len(got) == len(MESSAGES)
        for g, m in zip(got, MESSAGES):
            _equal(g, m)


def test_torn_tail_waits_for_the_writer(tmp_path):
    path = tmp_path / "0.scf"
    t_bin.write_frame(path, {"i": 0})
    whole = t_bin.encode({"i": 1})
    frame = b"SCF1" + struct.pack("<QI", len(whole), zlib.crc32(whole)) + whole
    with open(path, "ab") as f:
        f.write(frame[:-3])  # a writer mid-append
    readers = [t_bin.FrameReader(path), j_bin.FrameReader(path)]
    assert [[m["i"] for m in r.read_available()] for r in readers] == [[0], [0]]
    with open(path, "ab") as f:
        f.write(frame[-3:])
    assert [[m["i"] for m in r.read_available()] for r in readers] == [[1], [1]]


@pytest.mark.parametrize("fault", ["crc", "magic"])
def test_a_corrupt_frame_raises_ebadmsg(tmp_path, fault):
    path = tmp_path / "0.scf"
    t_bin.write_frame(path, {"i": 0})
    t_bin.write_frame(path, {"i": 1})
    data = bytearray(path.read_bytes())
    second = len(data) // 2
    if fault == "crc":
        data[-1] ^= 0xFF  # a payload byte of the second frame
    else:
        data[second : second + 4] = b"XXXX"
    path.write_bytes(bytes(data))
    for reader in (t_bin.FrameReader(path), j_bin.FrameReader(path)):
        with pytest.raises(OSError) as e:
            list(reader.read_available())
        assert e.value.errno == errno.EBADMSG


def test_training_batches_ride_as_arrays_on_the_binary_backend(tmp_path):
    """The preprocessor writes numpy columns on ``binary`` (as JAX's
    does), JSON lists elsewhere; both read back as the same batch."""
    from pipelinerl_tpu_torch.train.packing import make_sentinel_batch
    from pipelinerl_tpu_torch.types import TrainerBatch

    batch = make_sentinel_batch(16, 2)
    arrays, lists = batch.to_msg(arrays=True), batch.to_msg()
    assert isinstance(arrays["input_ids"], np.ndarray) and isinstance(lists["input_ids"], list)
    back = TrainerBatch.from_msg(t_bin.decode(t_bin.encode(arrays)))
    for name, value in batch.arrays().items():
        np.testing.assert_array_equal(getattr(back, name), value)
