"""Weight pushes between a trainer process and engine processes (PWT3).

Port of the JAX package's ``inference/weight_transfer.py``. The trainer
serializes its weights into one body and POSTs it to every engine's
``/receive_weight_update`` in parallel; the engine's transfer thread copies
the body to the card while decoding goes on, and the engine thread swaps
the new tree in between decode windows.

Wire format, byte for byte the JAX package's:
``PWT3 | u64 header_len | msgpack header | dtype-grouped blob``. The header
is ``{"version", "groups": [{"dtype", "byte_offset", "count"}], "tensors":
[{"name", "dtype", "shape", "elem_offset"}]}``; groups are sorted by dtype
name, tensors within a group by path, and each tensor's ``elem_offset``
indexes its group's typed run. ``bfloat16`` is named as ``ml_dtypes`` names
it. The card host has no ``msgpack``, so the header goes through the small
codec below, which covers what a header holds (maps, arrays, strings,
integers, with msgpack's smallest encodings) and writes what
``msgpack.packb`` writes.

Left out: ``gather_for_push`` and ``parallel_device_put`` serve trainer
meshes and TPU sub-streams; they wait for ROADMAP Queue 1 item 8.
"""

from __future__ import annotations

import json
import logging
import struct
import time
import urllib.request
import warnings
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Iterable

import numpy as np
import torch

logger = logging.getLogger(__name__)

_MAGIC = b"PWT3"

_DTYPES = {
    "bool": torch.bool, "uint8": torch.uint8, "int8": torch.int8, "int16": torch.int16,
    "int32": torch.int32, "int64": torch.int64, "float16": torch.float16,
    "bfloat16": torch.bfloat16, "float32": torch.float32, "float64": torch.float64,
}


def dtype_name(dtype: torch.dtype) -> str:
    """The wire name of a torch dtype (numpy's, and ``ml_dtypes``' for bf16)."""
    name = str(dtype).removeprefix("torch.")
    if name not in _DTYPES:
        raise ValueError(f"dtype {dtype} has no PWT3 name")
    return name


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


# ----------------------------------------------------------------------
# msgpack, the subset a PWT3 header uses
# ----------------------------------------------------------------------
def packb(obj: Any) -> bytes:
    """``msgpack.packb(obj)`` for None, bools, ints, floats, str, lists,
    tuples and dicts."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def _pack(obj: Any, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, float):
        out += b"\xcb" + struct.pack(">d", obj)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        n = len(raw)
        if n < 32:
            out.append(0xA0 | n)
        else:
            out += _sized(n, (0xD9, ">B"), (0xDA, ">H"), (0xDB, ">I"))
        out += raw
    elif isinstance(obj, (list, tuple)):
        n = len(obj)
        out += bytes([0x90 | n]) if n < 16 else _sized(n, None, (0xDC, ">H"), (0xDD, ">I"))
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        n = len(obj)
        out += bytes([0x80 | n]) if n < 16 else _sized(n, None, (0xDE, ">H"), (0xDF, ">I"))
        for key, value in obj.items():
            _pack(key, out)
            _pack(value, out)
    else:
        raise TypeError(f"cannot pack {type(obj).__name__}")


def _sized(n: int, s8, s16, s32) -> bytes:
    for limit, spec in ((1 << 8, s8), (1 << 16, s16), (1 << 32, s32)):
        if spec is not None and n < limit:
            return bytes([spec[0]]) + struct.pack(spec[1], n)
    raise ValueError(f"length {n} too large for msgpack")


def _pack_int(v: int, out: bytearray) -> None:
    if 0 <= v < 0x80 or -32 <= v < 0:
        out += struct.pack(">b" if v < 0 else ">B", v)
    elif v >= 0:
        for limit, code, fmt in ((1 << 8, 0xCC, ">B"), (1 << 16, 0xCD, ">H"), (1 << 32, 0xCE, ">I"), (1 << 64, 0xCF, ">Q")):
            if v < limit:
                out += bytes([code]) + struct.pack(fmt, v)
                return
        raise OverflowError(f"{v} does not fit msgpack's uint64")
    else:
        for limit, code, fmt in ((1 << 7, 0xD0, ">b"), (1 << 15, 0xD1, ">h"), (1 << 31, 0xD2, ">i"), (1 << 63, 0xD3, ">q")):
            if v >= -limit:
                out += bytes([code]) + struct.pack(fmt, v)
                return
        raise OverflowError(f"{v} does not fit msgpack's int64")


# fixed-size codes: code -> (struct format, size)
_FIXED = {
    0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
    0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8),
    0xCA: (">f", 4), 0xCB: (">d", 8),
}
# length-prefixed codes: code -> (kind, struct format of the length, size)
_SIZED = {
    0xD9: ("str", ">B", 1), 0xDA: ("str", ">H", 2), 0xDB: ("str", ">I", 4),
    0xDC: ("array", ">H", 2), 0xDD: ("array", ">I", 4),
    0xDE: ("map", ">H", 2), 0xDF: ("map", ">I", 4),
}


def unpackb(data: bytes | memoryview) -> Any:
    """``msgpack.unpackb(data, raw=False)`` for what ``packb`` writes."""
    view = memoryview(data)
    obj, pos = _unpack(view, 0)
    if pos != len(view):
        raise ValueError("extra bytes after the msgpack object")
    return obj


def _unpack(buf: memoryview, pos: int) -> tuple[Any, int]:
    code = buf[pos]
    pos += 1
    if code < 0x80:
        return code, pos
    if code >= 0xE0:
        return code - 0x100, pos
    if 0xA0 <= code < 0xC0:
        n = code & 0x1F
        return str(buf[pos : pos + n], "utf-8"), pos + n
    if 0x90 <= code < 0xA0:
        return _unpack_array(buf, pos, code & 0x0F)
    if 0x80 <= code < 0x90:
        return _unpack_map(buf, pos, code & 0x0F)
    if code in (0xC0, 0xC2, 0xC3):
        return {0xC0: None, 0xC2: False, 0xC3: True}[code], pos
    if code in _FIXED:
        fmt, size = _FIXED[code]
        return struct.unpack_from(fmt, buf, pos)[0], pos + size
    if code in _SIZED:
        kind, fmt, size = _SIZED[code]
        n = struct.unpack_from(fmt, buf, pos)[0]
        pos += size
        if kind == "str":
            return str(buf[pos : pos + n], "utf-8"), pos + n
        return (_unpack_array if kind == "array" else _unpack_map)(buf, pos, n)
    raise ValueError(f"msgpack code 0x{code:02x} is not part of a PWT3 header")


def _unpack_array(buf: memoryview, pos: int, n: int) -> tuple[list, int]:
    out = []
    for _ in range(n):
        item, pos = _unpack(buf, pos)
        out.append(item)
    return out, pos


def _unpack_map(buf: memoryview, pos: int, n: int) -> tuple[dict, int]:
    out = {}
    for _ in range(n):
        key, pos = _unpack(buf, pos)
        out[key], pos = _unpack(buf, pos)
    return out, pos


# ----------------------------------------------------------------------
# trees and the wire body
# ----------------------------------------------------------------------
def flatten_params(params: dict, prefix: str = "") -> Iterable[tuple[str, Any]]:
    for key, value in sorted(params.items()):
        path = f"{prefix}{key}"
        if isinstance(value, dict):
            yield from flatten_params(value, prefix=f"{path}/")
        else:
            yield path, value


def unflatten_params(flat: dict) -> dict:
    tree: dict = {}
    for path, value in flat.items():
        parts = path.split("/")
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return tree


def byte_view(buffer, offset: int = 0, count: int = -1) -> torch.Tensor:
    """A uint8 CPU tensor over ``buffer``'s bytes, without a copy; a
    read-only buffer (``bytes``) is read, never written."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return torch.frombuffer(buffer, dtype=torch.uint8, count=count, offset=offset)


def as_tensor(leaf) -> torch.Tensor:
    """A leaf as a tensor: torch tensors as they are, numpy arrays shared."""
    if isinstance(leaf, torch.Tensor):
        return leaf
    arr = np.ascontiguousarray(leaf)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return torch.from_numpy(arr)


def tensor_bytes(t: torch.Tensor) -> torch.Tensor:
    """The bytes of a tensor as a flat uint8 tensor on its device."""
    return t.detach().contiguous().reshape(-1).view(torch.uint8)


def serialize_params(params: dict, version: int) -> bytearray:
    """→ the PWT3 body of ``params`` (torch tensors on any device, or numpy
    arrays). Each leaf's bytes are copied once, from its device straight
    into the body."""
    by_dtype: dict[str, list[tuple[str, torch.Tensor]]] = {}
    for path, leaf in flatten_params(params):
        t = as_tensor(leaf)
        by_dtype.setdefault(dtype_name(t.dtype), []).append((path, t))
    groups, tensors, leaves = [], [], []
    byte_offset = 0
    for name in sorted(by_dtype):
        elem_offset = 0
        for path, t in by_dtype[name]:
            tensors.append({"name": path, "dtype": name, "shape": list(t.shape), "elem_offset": elem_offset})
            leaves.append(t)
            elem_offset += t.numel()
        groups.append({"dtype": name, "byte_offset": byte_offset, "count": elem_offset})
        byte_offset += elem_offset * torch_dtype(name).itemsize
    header = packb({"version": int(version), "groups": groups, "tensors": tensors})
    base = 12 + len(header)
    body = bytearray(base + byte_offset)
    body[:12] = _MAGIC + struct.pack("<Q", len(header))
    body[12:base] = header
    out = byte_view(body)
    pos = base
    for t in leaves:
        n = t.numel() * t.element_size()
        if n:
            out[pos : pos + n].copy_(tensor_bytes(t))
        pos += n
    return body


def parse_push_header(body) -> tuple[list[dict], list[dict], int, int]:
    """→ (dtype groups, tensor entries, version, blob base offset)."""
    if bytes(body[:4]) != _MAGIC:
        raise ValueError("not a PWT3 weight-push body")
    (header_len,) = struct.unpack_from("<Q", body, 4)
    header = unpackb(memoryview(body)[12 : 12 + header_len])
    return header["groups"], header["tensors"], int(header["version"]), 12 + header_len


def entry_count(entry: dict) -> int:
    count = 1
    for s in entry["shape"]:
        count *= int(s)
    return count


def deserialize_params(body) -> tuple[dict, int]:
    """→ (tree of CPU tensors, version). Each tensor views ``body``'s bytes
    (``torch.frombuffer``: numpy has no bf16), with no copy."""
    groups, tensors, version, base = parse_push_header(body)
    group_off = {g["dtype"]: g["byte_offset"] for g in groups}
    flat = {}
    for t in tensors:
        dt = torch_dtype(t["dtype"])
        count = entry_count(t)
        off = base + group_off[t["dtype"]] + t["elem_offset"] * dt.itemsize
        raw = byte_view(body, off, count * dt.itemsize) if count else torch.empty(0, dtype=torch.uint8)
        flat[t["name"]] = raw.view(dt).reshape(t["shape"])
    return unflatten_params(flat), version


def post_weights(url: str, body, timeout: float) -> dict:
    """POST one PWT3 body to ``url``'s ``/receive_weight_update``; → the
    server's reply."""
    req = urllib.request.Request(
        f"{url}/receive_weight_update", data=body,
        headers={"Content-Type": "application/x-msgpack"}, method="POST",
    )
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        if resp.status != 200:
            raise RuntimeError(f"weight push to {url} failed: HTTP {resp.status}")
        return json.loads(resp.read() or b"{}")


def push_weights_http(urls: list[str], params: dict, version: int, timeout: float | None = None) -> dict:
    """POST the serialized params to every engine server in parallel; each
    server replies 200 once it serves ``version``. Any failure raises after
    all pushes settle. The default timeout outlasts the server's 600 s wait
    for the swap: 660 s plus 1 s per 50 MB of body.

    Returns the push's timings: body bytes, serialize seconds, POST-to-200
    seconds, and each server's reply."""
    t0 = time.monotonic()
    body = serialize_params(params, version)
    serialize_s = time.monotonic() - t0
    if timeout is None:
        timeout = 660.0 + len(body) / 50e6
    t1 = time.monotonic()
    replies, errors = {}, []
    with ThreadPoolExecutor(max_workers=max(1, len(urls))) as pool:
        futures = {pool.submit(post_weights, url, body, timeout): url for url in urls}
        for fut, url in futures.items():
            try:
                replies[url] = fut.result()
            except Exception as exc:  # noqa: BLE001 - every broken URL is reported, then raised
                logger.error("weight push to %s failed: %s", url, exc)
                errors.append((url, exc))
    if errors:
        raise RuntimeError(f"weight push failed for {[u for u, _ in errors]}")
    post_s = time.monotonic() - t1
    logger.info("Pushed %.1f MB of weights (v%d) to %d engine(s): serialize %.2f s, POST to 200 %.2f s",
                len(body) / 1e6, version, len(urls), serialize_s, post_s)
    return {"bytes": len(body), "serialize_s": serialize_s, "post_s": post_s, "replies": replies}
