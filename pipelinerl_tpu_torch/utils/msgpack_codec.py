"""msgpack on the stdlib: the subset the port's wire formats carry.

The card host has no ``msgpack``. ``packb`` writes what
``msgpack.packb(obj, default=default, use_bin_type=True)`` writes for nil,
bools, ints, floats (float64), str, bytes (bin), lists, tuples and dicts,
each in msgpack's smallest encoding; ``default`` is called for any other
type and its result packed in its place. ``unpackb`` reads what
``msgpack.unpackb(data, raw=False, strict_map_key=False, object_hook=...)``
reads for those types (float32 included), calling ``object_hook`` on every
map. PWT3 headers (``inference/weight_transfer.py``) and stream payloads
(``streams_binary.py``) go through it.
"""

from __future__ import annotations

import struct
from typing import Any, Callable


def packb(obj: Any, default: Callable[[Any], Any] | None = None) -> bytes:
    out = bytearray()
    _pack(obj, out, default)
    return bytes(out)


def _pack(obj: Any, out: bytearray, default) -> None:
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
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = bytes(obj)
        out += _sized(len(raw), (0xC4, ">B"), (0xC5, ">H"), (0xC6, ">I"))
        out += raw
    elif isinstance(obj, (list, tuple)):
        n = len(obj)
        out += bytes([0x90 | n]) if n < 16 else _sized(n, None, (0xDC, ">H"), (0xDD, ">I"))
        for item in obj:
            _pack(item, out, default)
    elif isinstance(obj, dict):
        n = len(obj)
        out += bytes([0x80 | n]) if n < 16 else _sized(n, None, (0xDE, ">H"), (0xDF, ">I"))
        for key, value in obj.items():
            _pack(key, out, default)
            _pack(value, out, default)
    elif default is not None:
        _pack(default(obj), out, None)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


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
    0xC4: ("bin", ">B", 1), 0xC5: ("bin", ">H", 2), 0xC6: ("bin", ">I", 4),
    0xD9: ("str", ">B", 1), 0xDA: ("str", ">H", 2), 0xDB: ("str", ">I", 4),
    0xDC: ("array", ">H", 2), 0xDD: ("array", ">I", 4),
    0xDE: ("map", ">H", 2), 0xDF: ("map", ">I", 4),
}


def unpackb(data: bytes | memoryview, object_hook: Callable[[dict], Any] | None = None) -> Any:
    view = memoryview(data)
    obj, pos = _unpack(view, 0, object_hook)
    if pos != len(view):
        raise ValueError("extra bytes after the msgpack object")
    return obj


def _unpack(buf: memoryview, pos: int, hook) -> tuple[Any, int]:
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
        return _unpack_array(buf, pos, code & 0x0F, hook)
    if 0x80 <= code < 0x90:
        return _unpack_map(buf, pos, code & 0x0F, hook)
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
        if kind == "bin":
            return bytes(buf[pos : pos + n]), pos + n
        return (_unpack_array if kind == "array" else _unpack_map)(buf, pos, n, hook)
    raise ValueError(f"msgpack code 0x{code:02x} is not one the port reads")


def _unpack_array(buf: memoryview, pos: int, n: int, hook) -> tuple[list, int]:
    out = []
    for _ in range(n):
        item, pos = _unpack(buf, pos, hook)
        out.append(item)
    return out, pos


def _unpack_map(buf: memoryview, pos: int, n: int, hook) -> tuple[Any, int]:
    out = {}
    for _ in range(n):
        key, pos = _unpack(buf, pos, hook)
        out[key], pos = _unpack(buf, pos, hook)
    return (hook(out) if hook is not None else out), pos
