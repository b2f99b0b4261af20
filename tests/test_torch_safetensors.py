"""The port's safetensors reader and writer (``utils/safetensors_io.py``)
against ``safetensors.numpy``: the port reads what ``save_file`` wrote,
every dtype it handles, a scalar and a zero-size tensor included, and its
writer's bytes equal ``save_file``'s for the same dict."""

import ml_dtypes
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file as np_load_file
from safetensors.numpy import save_file as np_save_file

from pipelinerl_tpu_torch.utils import safetensors_io as st

torch.set_num_threads(1)


def arrays(seed: int) -> dict[str, np.ndarray]:
    """One tensor of every dtype the port handles, a scalar, a zero-size
    tensor and names that sort differently by bytes and by dtype."""
    rng = np.random.default_rng(seed)
    return {
        "model.layers.0.f32": rng.normal(size=(3, 5)).astype(np.float32),
        "model.layers.10.bf16": rng.normal(size=(4, 2, 3)).astype(ml_dtypes.bfloat16),
        "model.layers.2.f16": rng.normal(size=(7,)).astype(np.float16),
        "f64_scalar": np.array(rng.normal(), np.float64),
        "i32": rng.integers(-2**31, 2**31 - 1, size=(6,), dtype=np.int32),
        "i64": rng.integers(-2**62, 2**62, size=(2, 3), dtype=np.int64),
        "u8": rng.integers(0, 256, size=(9,), dtype=np.uint8),
        "mask": rng.random(5) > 0.5,
        "empty": np.zeros((0, 4), np.float32),
        "Zebra": np.ones((1,), np.float32),
        "é_non_ascii": np.full((2,), 3, np.int32),
    }


def to_torch(a: np.ndarray) -> torch.Tensor:
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def to_numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


@pytest.mark.parametrize("seed", [0, 1])
def test_reads_what_safetensors_wrote(tmp_path, seed):
    ref = arrays(seed)
    np_save_file(ref, str(tmp_path / "ref.safetensors"))
    got = st.load_file(tmp_path / "ref.safetensors")
    assert sorted(got) == sorted(ref)
    for name, a in ref.items():
        t = got[name]
        assert tuple(t.shape) == a.shape, name
        assert to_numpy(t).dtype == a.dtype, name
        assert to_numpy(t).tobytes() == a.tobytes(), name


@pytest.mark.parametrize("seed", [0, 1])
def test_writer_bytes_equal_safetensors(tmp_path, seed):
    ref = arrays(seed)
    np_save_file(ref, str(tmp_path / "ref.safetensors"))
    size = st.save_file({k: to_torch(v) for k, v in ref.items()}, tmp_path / "ours.safetensors")
    ours = (tmp_path / "ours.safetensors").read_bytes()
    assert ours == (tmp_path / "ref.safetensors").read_bytes()
    assert size == len(ours)


def test_writer_from_views_and_reader_past_metadata(tmp_path):
    """Transposed and sliced views are written as their C-order values; the
    reader skips the ``__metadata__`` entry that transformers writes."""
    from safetensors.numpy import save

    base = torch.arange(24, dtype=torch.float32).reshape(2, 3, 4)
    views = {"t": base[1].T, "s": base[:, 1]}
    st.save_file(views, tmp_path / "v.safetensors")
    dense = {k: np.ascontiguousarray(v.numpy()) for k, v in views.items()}
    assert (tmp_path / "v.safetensors").read_bytes() == save(dense)
    back = np_load_file(str(tmp_path / "v.safetensors"))
    np.testing.assert_array_equal(back["t"], views["t"].numpy())
    (tmp_path / "m.safetensors").write_bytes(save(dense, metadata={"format": "pt"}))
    got = st.load_file(tmp_path / "m.safetensors")
    assert sorted(got) == ["s", "t"] and torch.equal(got["t"], views["t"])


def test_directory_index_reads_each_file_lazily(tmp_path):
    a, b = arrays(0), arrays(1)
    np_save_file({f"a.{k}": v for k, v in a.items()}, str(tmp_path / "model-00001-of-00002.safetensors"))
    np_save_file({f"b.{k}": v for k, v in b.items()}, str(tmp_path / "model-00002-of-00002.safetensors"))
    index = st.SafetensorsDir(tmp_path, normalize=lambda name: name.upper())
    assert all(f"A.{k.upper()}" in index and f"B.{k.upper()}" in index for k in a)
    assert "A.MASK" in index and "a.mask" not in index
    np.testing.assert_array_equal(to_numpy(index.get("B.I64")), b["i64"])
    with pytest.raises(KeyError):
        index.get("missing")
    with pytest.raises(FileNotFoundError):
        st.SafetensorsDir(tmp_path / "nowhere")


def test_unsupported_dtypes_and_short_files_raise(tmp_path):
    with pytest.raises(ValueError):
        st.save_file({"x": torch.zeros(2, dtype=torch.int16)}, tmp_path / "x.safetensors")
    np_save_file({"x": np.zeros(2, np.int16)}, str(tmp_path / "i16.safetensors"))
    with pytest.raises(ValueError):
        st.load_file(tmp_path / "i16.safetensors")
    st.save_file({"x": torch.ones(64)}, tmp_path / "cut.safetensors")
    data = (tmp_path / "cut.safetensors").read_bytes()
    (tmp_path / "cut.safetensors").write_bytes(data[:-8])
    with pytest.raises(ValueError):
        st.load_file(tmp_path / "cut.safetensors")
