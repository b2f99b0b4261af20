"""Binary stream files: CRC-framed msgpack payloads (``.scf``).

Port of the JAX package's ``streams_binary.py`` and of the frame codec it
calls (the root ``native/streamcodec.cpp``) on the stdlib. A frame is

    magic "SCF1" | payload length (u64 LE) | CRC-32 of the payload (u32 LE) | payload

with zlib's CRC-32, appended by one ``writev`` on an ``O_APPEND``
descriptor. A payload is msgpack (``utils/msgpack_codec.py``): numpy arrays
travel as maps tagged ``__nd__`` with ``dtype``, ``shape`` and ``data``.
Either package reads the other's files. A reader returns only complete
frames and leaves a torn tail (a writer mid-append) for a later call; a bad
magic or a CRC mismatch raises ``OSError(EBADMSG)``.
"""

from __future__ import annotations

import errno
import os
import struct
import zlib
from pathlib import Path
from typing import Any, Iterator

import numpy as np

from .utils.msgpack_codec import packb, unpackb

_ND_KEY = "__nd__"
MAGIC = b"SCF1"
_HEADER = struct.Struct("<4sQI")  # magic, payload length, CRC-32


def _default(obj: Any):
    if isinstance(obj, np.ndarray):
        return {_ND_KEY: True, "dtype": obj.dtype.str, "shape": list(obj.shape), "data": obj.tobytes()}
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    raise TypeError(f"Unserializable type {type(obj)}")


def _object_hook(obj: dict) -> Any:
    if obj.get(_ND_KEY):
        return np.frombuffer(obj["data"], dtype=np.dtype(obj["dtype"])).reshape(obj["shape"]).copy()
    return obj


def encode(msg: dict) -> bytes:
    return packb(msg, default=_default)


def decode(payload: bytes) -> dict:
    return unpackb(payload, object_hook=_object_hook)


def write_payload(path: str | Path, payload: bytes) -> None:
    """Append one frame holding ``payload``."""
    header = _HEADER.pack(MAGIC, len(payload), zlib.crc32(payload))
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
    try:
        written = os.writev(fd, [header, payload])
    finally:
        os.close(fd)
    if written != len(header) + len(payload):
        raise OSError(errno.EIO, f"short write of a frame to {path}")


def write_frame(path: str | Path, msg: dict) -> None:
    write_payload(path, encode(msg))


class FrameReader:
    """Tail-follow reader over a framed file."""

    def __init__(self, path: str | Path):
        self.path = str(path)
        self.offset = 0

    def read_available(self) -> Iterator[dict]:
        """Every complete frame past the offset, decoded; the offset moves
        past them, and a torn tail stays for a later call."""
        try:
            with open(self.path, "rb") as f:
                f.seek(self.offset)
                data = f.read()
        except FileNotFoundError:
            return
        payloads, pos = [], 0
        while pos + _HEADER.size <= len(data):
            magic, length, crc = _HEADER.unpack_from(data, pos)
            if magic != MAGIC:
                raise OSError(errno.EBADMSG, f"bad frame magic at byte {self.offset + pos} of {self.path}")
            end = pos + _HEADER.size + length
            if end > len(data):
                break  # torn tail: wait for the writer
            payload = data[pos + _HEADER.size : end]
            if zlib.crc32(payload) != crc:
                raise OSError(errno.EBADMSG, f"CRC mismatch at byte {self.offset + pos} of {self.path}")
            payloads.append(payload)
            pos = end
        self.offset += pos
        for payload in payloads:
            yield decode(payload)
