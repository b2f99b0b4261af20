"""Append-only ordered message streams connecting the pipeline stages.

Port of the JAX package's ``streams.py``. A stream is addressed by (topic,
instance, partition); writers append dict messages, readers tail-follow
from the beginning. Four backends, each readable by the other package:

- ``files``: one JSONL file per partition under
  ``<exp>/streams/<topic>/<instance>/<partition>.jsonl``; a reader consumes
  only newline-terminated lines, so a writer caught mid-append never tears
  a message;
- ``memory``: in-process lists with condition variables (one process);
- ``binary``: ``.scf`` files of CRC-framed msgpack (``streams_binary.py``)
  in the same layout;
- ``tcp``: every topic through the stream hub (``streams_tcp.py``), for
  stages on more than one host.
"""

from __future__ import annotations

import io
import json
import threading
import time
from collections import deque
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator

from .streams_binary import FrameReader, write_frame
from .streams_tcp import TcpStreamReader, TcpStreamWriter

BACKENDS = ("files", "memory", "binary", "tcp")
_BACKEND = "files"
_HUB_ADDR: str | None = None


def set_streams_backend(backend: str, hub: str | None = None) -> None:
    """Select the process-wide default backend; ``tcp`` needs the hub's
    ``host:port`` (given here or before)."""
    global _BACKEND, _HUB_ADDR
    if backend not in BACKENDS:
        raise ValueError(f"Unknown streams backend {backend!r}")
    if backend == "tcp" and hub is None and _HUB_ADDR is None:
        raise ValueError("tcp streams backend requires hub='host:port'")
    if hub is not None:
        _HUB_ADDR = hub
    _BACKEND = backend


def get_streams_backend() -> str:
    return _BACKEND


def get_streams_hub() -> str | None:
    return _HUB_ADDR


def _hub_addr() -> str:
    if _HUB_ADDR is None:
        raise ValueError("tcp backend: call set_streams_backend('tcp', hub=...) first")
    return _HUB_ADDR


@dataclass(frozen=True)
class SingleStreamSpec:
    exp_path: str
    topic: str
    instance: int = 0
    partition: int = 0


@dataclass(frozen=True)
class StreamRangeSpec:
    """A set of partitions of one topic; writes round-robin unless a
    partition is named."""

    exp_path: str
    topic: str
    instance: int = 0
    partitions: tuple[int, ...] = (0,)

    def single(self, partition: int) -> SingleStreamSpec:
        if partition not in self.partitions:
            raise ValueError(f"partition {partition} not in {self.partitions}")
        return SingleStreamSpec(self.exp_path, self.topic, self.instance, partition)


class _MemoryStream:
    def __init__(self) -> None:
        self.messages: list[dict] = []
        self.cond = threading.Condition()

    def append(self, msg: dict) -> None:
        with self.cond:
            self.messages.append(msg)
            self.cond.notify_all()


_MEMORY_STREAMS: dict[tuple, _MemoryStream] = {}
_MEMORY_LOCK = threading.Lock()


def _memory_stream(spec: SingleStreamSpec) -> _MemoryStream:
    key = (spec.exp_path, spec.topic, spec.instance, spec.partition)
    with _MEMORY_LOCK:
        if key not in _MEMORY_STREAMS:
            _MEMORY_STREAMS[key] = _MemoryStream()
        return _MEMORY_STREAMS[key]


def stream_file_path(spec: SingleStreamSpec, backend: str = "files") -> Path:
    ext = "scf" if backend == "binary" else "jsonl"
    return Path(spec.exp_path) / "streams" / spec.topic / str(spec.instance) / f"{spec.partition}.{ext}"


class StreamWriter:
    """Writer for a single partition."""

    def __init__(self, spec: SingleStreamSpec, backend: str | None = None):
        self.spec = spec
        self.backend = backend or _BACKEND
        self._fh: io.TextIOBase | None = None
        self._tcp: TcpStreamWriter | None = None
        if self.backend == "files":
            path = stream_file_path(spec)
            path.parent.mkdir(parents=True, exist_ok=True)
            self._fh = open(path, "a", buffering=1024 * 1024)
        elif self.backend == "binary":
            self._path = stream_file_path(spec, "binary")
            self._path.parent.mkdir(parents=True, exist_ok=True)
        elif self.backend == "tcp":
            self._tcp = TcpStreamWriter(spec, _hub_addr())
        else:
            self._mem = _memory_stream(spec)

    def write(self, msg: dict) -> None:
        if self.backend == "files":
            assert self._fh is not None
            self._fh.write(json.dumps(msg, separators=(",", ":")) + "\n")
            self._fh.flush()
        elif self.backend == "binary":
            write_frame(self._path, msg)
        elif self.backend == "tcp":
            assert self._tcp is not None
            self._tcp.write(msg)
        else:
            self._mem.append(msg)

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
        if self._tcp is not None:
            self._tcp.close()
            self._tcp = None

    def __enter__(self) -> "StreamWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class RangeStreamWriter:
    """Round-robin writer over the partitions of a StreamRangeSpec."""

    def __init__(self, spec: StreamRangeSpec, backend: str | None = None):
        self.spec = spec
        self._writers = {p: StreamWriter(spec.single(p), backend) for p in spec.partitions}
        self._next = 0

    def write(self, msg: dict, partition: int | None = None) -> int:
        if partition is None:
            partition = self.spec.partitions[self._next % len(self.spec.partitions)]
            self._next += 1
        self._writers[partition].write(msg)
        return partition

    def close(self) -> None:
        for w in self._writers.values():
            w.close()

    def __enter__(self) -> "RangeStreamWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class StreamReader:
    """Tail-follow reader for a single partition: ``read()`` yields messages
    until ``stop()``; ``read_available()`` yields what is present and
    returns."""

    def __init__(self, spec: SingleStreamSpec, backend: str | None = None, poll_interval: float = 0.05):
        self.spec = spec
        self.backend = backend or _BACKEND
        self.poll_interval = poll_interval
        self._offset = 0  # bytes of the file consumed (files), or messages (memory)
        self._buf = b""
        # messages drained from the backend but not yet handed out
        # (read_available may stop mid-chunk; nothing may be lost)
        self._pending: deque[dict] = deque()
        self._frame_reader: FrameReader | None = None
        self._tcp: TcpStreamReader | None = None
        if self.backend == "binary":
            self._frame_reader = FrameReader(stream_file_path(spec, "binary"))
        elif self.backend == "tcp":
            self._tcp = TcpStreamReader(spec, _hub_addr(), poll_interval)
        self._stop = threading.Event()

    def stop(self) -> None:
        self._stop.set()
        if self._tcp is not None:
            self._tcp.stop()
        if self.backend == "memory":
            mem = _memory_stream(self.spec)
            with mem.cond:
                mem.cond.notify_all()

    def _drain_file(self) -> Iterator[dict]:
        path = stream_file_path(self.spec)
        if not path.exists():
            return
        with open(path, "rb") as f:
            f.seek(self._offset)
            chunk = f.read()
        if not chunk:
            return
        data = self._buf + chunk
        self._offset += len(chunk)
        last_nl = data.rfind(b"\n")
        if last_nl == -1:  # keep a torn tail buffered
            self._buf = data
            return
        complete, self._buf = data[: last_nl + 1], data[last_nl + 1 :]
        for line in complete.splitlines():
            if line:
                yield json.loads(line)

    def _drain(self) -> None:
        if self.backend == "tcp":
            self._pending.extend(self._tcp.read_available())
        elif self.backend == "binary":
            self._pending.extend(self._frame_reader.read_available())
        elif self.backend == "files":
            self._pending.extend(self._drain_file())
        else:
            mem = _memory_stream(self.spec)
            with mem.cond:
                msgs = mem.messages[self._offset :]
                self._offset = len(mem.messages)
            self._pending.extend(msgs)

    def read_available(self, max_messages: int | None = None) -> Iterator[dict]:
        self._drain()
        count = 0
        while self._pending:
            if max_messages is not None and count >= max_messages:
                return
            yield self._pending.popleft()
            count += 1

    def read(self) -> Iterator[dict]:
        while not self._stop.is_set():
            got = False
            for msg in self.read_available():
                got = True
                yield msg
            if got:
                continue
            if self.backend == "memory":
                mem = _memory_stream(self.spec)
                with mem.cond:
                    if len(mem.messages) == self._offset and not self._pending:
                        mem.cond.wait(timeout=self.poll_interval)
            elif self.backend == "tcp":
                # the hub holds the request up to poll_interval when nothing is new
                self._pending.extend(self._tcp.read_available(wait_s=self.poll_interval))
            else:
                time.sleep(self.poll_interval)


def write_to_stream(spec: SingleStreamSpec, msg: dict, backend: str | None = None) -> None:
    """One-shot write (opens and closes a writer)."""
    with StreamWriter(spec, backend) as w:
        w.write(msg)
