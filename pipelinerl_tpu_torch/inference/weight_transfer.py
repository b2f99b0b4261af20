"""Weight pushes between a trainer process and engine processes (PWT3).

Port of the JAX package's ``inference/weight_transfer.py``. The trainer
serializes its weights into one body and POSTs it to every engine's
``/receive_weight_update`` in parallel; the engine's transfer thread copies
the body to the card while decoding goes on, and the engine thread swaps
the new tree in between decode windows (a body over the engine's
double-buffer budget is instead copied into the live weights piece by
piece, ``blob-chunked``).

Wire format, byte for byte the JAX package's:
``PWT3 | u64 header_len | msgpack header | dtype-grouped blob``. The header
is ``{"version", "groups": [{"dtype", "byte_offset", "count"}], "tensors":
[{"name", "dtype", "shape", "elem_offset"}]}``; groups are sorted by dtype
name, tensors within a group by path, and each tensor's ``elem_offset``
indexes its group's typed run. ``bfloat16`` is named as ``ml_dtypes`` names
it. The card host has no ``msgpack``, so the header goes through the port's
own codec (``utils/msgpack_codec.py``), which writes what ``msgpack.packb``
writes.

``gather_for_push`` gives a push the full tensors of a trainer world's
shards (dp and tp): every rank joins the all-gather, and rank 0 serializes
them. JAX's
``parallel_device_put`` (TPU sub-streams splitting a host-to-device copy)
has no port: the engine's transfer thread (``InferenceEngine``) copies a
body to the card while decoding goes on, which is that function's job.
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

from ..utils.msgpack_codec import packb, unpackb

logger = logging.getLogger(__name__)

_MAGIC = b"PWT3"

_DTYPES = {
    "bool": torch.bool, "uint8": torch.uint8, "int8": torch.int8, "int16": torch.int16,
    "int32": torch.int32, "int64": torch.int64, "float16": torch.float16,
    "bfloat16": torch.bfloat16, "float32": torch.float32, "float64": torch.float64,
}


def gather_for_push(params: dict, mesh, cut=None) -> dict:
    """The full tensors a cross-process push serializes: with ``mesh`` None
    the params as they are, else every leaf all-gathered over dp and tp on
    every rank (a collective: each rank calls it; rank 0 then serializes);
    ``cut`` is the trainer's ``sharding.TPCut``."""
    if mesh is None:
        return params
    from ..parallel.sharding import TPCut, unshard_params

    return unshard_params(params, mesh, cut or TPCut())


def dtype_name(dtype: torch.dtype) -> str:
    """The wire name of a torch dtype (numpy's, and ``ml_dtypes``' for bf16)."""
    name = str(dtype).removeprefix("torch.")
    if name not in _DTYPES:
        raise ValueError(f"dtype {dtype} has no PWT3 name")
    return name


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


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
