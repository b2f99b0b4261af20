"""Append-only ordered message streams connecting the pipeline stages.

Port of the JAX package's ``streams.py``, files backend only: one JSONL file
per partition under ``<exp>/streams/<topic>/<instance>/<partition>.jsonl``,
written and read exactly as the JAX package does, so either package can
follow the other's streams. Readers only consume newline-terminated lines,
so a writer caught mid-append never tears a message.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator


def set_streams_backend(backend: str) -> None:
    """Select the process-wide backend; the port has the files backend only
    (the TCP and binary backends are not ported)."""
    if backend != "files":
        raise NotImplementedError(f"streams backend {backend!r} is not ported; use 'files'")


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


def stream_file_path(spec: SingleStreamSpec) -> Path:
    return Path(spec.exp_path) / "streams" / spec.topic / str(spec.instance) / f"{spec.partition}.jsonl"


class StreamWriter:
    """Writer for a single partition."""

    def __init__(self, spec: SingleStreamSpec):
        self.spec = spec
        path = stream_file_path(spec)
        path.parent.mkdir(parents=True, exist_ok=True)
        self._fh = open(path, "a", buffering=1024 * 1024)

    def write(self, msg: dict) -> None:
        assert self._fh is not None
        self._fh.write(json.dumps(msg, separators=(",", ":")) + "\n")
        self._fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self) -> "StreamWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class RangeStreamWriter:
    """Round-robin writer over the partitions of a StreamRangeSpec."""

    def __init__(self, spec: StreamRangeSpec):
        self.spec = spec
        self._writers = {p: StreamWriter(spec.single(p)) for p in spec.partitions}
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

    def __init__(self, spec: SingleStreamSpec, poll_interval: float = 0.05):
        self.spec = spec
        self.poll_interval = poll_interval
        self._offset = 0  # bytes of the file consumed
        self._buf = b""
        # messages drained from the file but not yet handed out
        # (read_available may stop mid-chunk; nothing may be lost)
        self._pending: deque[dict] = deque()
        self._stop = threading.Event()

    def stop(self) -> None:
        self._stop.set()

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

    def read_available(self, max_messages: int | None = None) -> Iterator[dict]:
        self._pending.extend(self._drain_file())
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
            if not got:
                time.sleep(self.poll_interval)


def write_to_stream(spec: SingleStreamSpec, msg: dict) -> None:
    """One-shot write (opens and closes a writer)."""
    with StreamWriter(spec) as w:
        w.write(msg)
