"""The safetensors file format, read and written without the ``safetensors``
package (the H100 host does not have it).

A file is an 8-byte little-endian header length ``n``, ``n`` bytes of JSON
header, then the tensors' raw little-endian bytes. The header maps each
name to ``{"dtype", "shape", "data_offsets": [begin, end]}`` (offsets into
the byte buffer after the header), plus an optional ``"__metadata__"`` map
of strings, which the reader skips.

- ``save_file`` writes the bytes ``safetensors.numpy.save_file`` writes for
  the same dict: tensors ordered by dtype (widest first, in the library's
  enum order) and then by name, compact JSON, and the header padded with
  spaces to a multiple of 8 bytes.
- ``SafetensorsDir`` indexes every ``*.safetensors`` file of a directory by
  name and reads one tensor's bytes at a time into ``torch.frombuffer``, so
  a checkpoint loads through host memory one tensor at a time. bf16 needs
  no numpy dtype.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Mapping

import torch

# name -> (torch dtype, bytes per element). The order is the library's
# ``Dtype`` enum order; ``save_file`` writes the latest first.
_DTYPES = {
    "BOOL": (torch.bool, 1),
    "U8": (torch.uint8, 1),
    "F16": (torch.float16, 2),
    "BF16": (torch.bfloat16, 2),
    "I32": (torch.int32, 4),
    "F32": (torch.float32, 4),
    "F64": (torch.float64, 8),
    "I64": (torch.int64, 8),
}
_ENUM_RANK = {name: i for i, name in enumerate(_DTYPES)}
_NAME_OF = {torch_dtype: name for name, (torch_dtype, _) in _DTYPES.items()}


def _dtype_name(t: torch.Tensor) -> str:
    if t.dtype not in _NAME_OF:
        raise ValueError(f"safetensors_io writes {sorted(_DTYPES)}, not {t.dtype}")
    return _NAME_OF[t.dtype]


def _raw_bytes(t: torch.Tensor) -> memoryview:
    """A tensor's bytes in C order on the host (the format is little-endian,
    as every host torch runs on)."""
    t = t.detach().to("cpu").contiguous()
    if t.numel() == 0:
        return memoryview(b"")
    return memoryview(t.reshape(-1).view(torch.uint8).numpy())


def header_of(tensors: Mapping[str, torch.Tensor]) -> tuple[bytes, list[str]]:
    """(header bytes with the 8-byte length, tensor names in file order)."""
    order = sorted(tensors, key=lambda name: (-_ENUM_RANK[_dtype_name(tensors[name])], name))
    header: dict = {}
    offset = 0
    for name in order:
        t = tensors[name]
        n_bytes = t.numel() * _DTYPES[_dtype_name(t)][1]
        header[name] = {"dtype": _dtype_name(t), "shape": list(t.shape), "data_offsets": [offset, offset + n_bytes]}
        offset += n_bytes
    text = json.dumps(header, separators=(",", ":"), ensure_ascii=False).encode("utf-8")
    text += b" " * (-len(text) % 8)
    return struct.pack("<Q", len(text)) + text, order


def save_file(tensors: Mapping[str, torch.Tensor], path: str | Path) -> int:
    """Write ``tensors`` (on any device) to ``path``; returns the file size
    in bytes. Each tensor is copied to the host as it is written."""
    header, order = header_of(tensors)
    size = len(header)
    with open(path, "wb") as f:
        f.write(header)
        for name in order:
            data = _raw_bytes(tensors[name])
            f.write(data)
            size += data.nbytes
    return size


def read_header(path: str | Path) -> tuple[dict, int]:
    """(the header's tensor entries, the file offset of the byte buffer)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    return header, 8 + n


def read_tensor(path: str | Path, entry: dict, base: int) -> torch.Tensor:
    """One tensor of a file, from its header entry, as a host tensor that
    owns its bytes."""
    if entry["dtype"] not in _DTYPES:
        raise ValueError(f"safetensors_io reads {sorted(_DTYPES)}, not {entry['dtype']}")
    dtype, width = _DTYPES[entry["dtype"]]
    begin, end = entry["data_offsets"]
    shape = tuple(entry["shape"])
    n = 1
    for s in shape:
        n *= s
    if end - begin != n * width:
        raise ValueError(f"{path}: data_offsets {entry['data_offsets']} do not hold {shape} of {entry['dtype']}")
    if n == 0:
        return torch.empty(shape, dtype=dtype)
    buf = bytearray(end - begin)
    with open(path, "rb") as f:
        f.seek(base + begin)
        if f.readinto(buf) != len(buf):
            raise ValueError(f"{path} is shorter than its header says")
    return torch.frombuffer(buf, dtype=dtype).reshape(shape)


def load_file(path: str | Path) -> dict[str, torch.Tensor]:
    """Every tensor of one file, in file order."""
    header, base = read_header(path)
    return {name: read_tensor(path, entry, base) for name, entry in header.items()}


class SafetensorsDir:
    """A name index over every ``*.safetensors`` file of a directory; each
    tensor's bytes are read when it is asked for, so host memory holds one
    tensor at a time. ``normalize`` maps a stored name to the name callers
    ask for."""

    def __init__(self, directory: str | Path, normalize=lambda name: name):
        files = sorted(Path(directory).glob("*.safetensors"))
        if not files:
            raise FileNotFoundError(f"No *.safetensors under {directory}")
        self._index: dict[str, tuple[Path, dict, int]] = {}
        for path in files:
            header, base = read_header(path)
            for name, entry in header.items():
                self._index[normalize(name)] = (path, entry, base)

    def __contains__(self, name: str) -> bool:
        return name in self._index

    def get(self, name: str) -> torch.Tensor:
        if name not in self._index:
            raise KeyError(f"Missing tensor {name!r} in checkpoint")
        return read_tensor(*self._index[name])
