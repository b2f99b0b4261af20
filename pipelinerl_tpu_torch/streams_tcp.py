"""Cross-host streams through a TCP stream hub (the role Redis plays in the
reference).

Port of the JAX package's ``streams_tcp.py``, wire-compatible with it: one
hub process per experiment serves append-only logs, one per stream key
(``topic/instance/partition``), over persistent TCP connections, and either
package's clients talk to either package's hub. Payloads are the binary
backend's msgpack (``streams_binary.py``).

    request : u32 header_len | JSON header | u64 body_len | body
    response: u32 header_len | JSON header | u64 body_len | body

- ``{"op": "append", "key": k, "n": N}``, body N x (u32 len | payload);
- ``{"op": "read", "key": k, "offset": i, "max": M, "wait_s": W}`` answers
  ``{"ok": 1, "offset": j}`` with frames i..j, long-polling up to W seconds
  when nothing is new;
- ``{"op": "ping"}`` answers ``{"ok": 1}``.

Ordered and append-only, as the file backends: a late reader replays from
offset 0 and tail-follows. Each log keeps its last ``maxlen`` entries; a
reader behind the trim resumes at the oldest one kept. With
``persist_dir`` the hub mirrors every log to a ``.scf`` file
(``<persist_dir>/<key>.scf``) that ``streams_binary.FrameReader`` reads.
"""

from __future__ import annotations

import json
import logging
import socket
import socketserver
import struct
import threading
import time
from pathlib import Path

from .streams_binary import decode, encode, write_payload

logger = logging.getLogger(__name__)

_U32 = struct.Struct("<I")
_U64 = struct.Struct("<Q")


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf.extend(chunk)
    return bytes(buf)


def _send_msg(sock: socket.socket, header: dict, body: bytes = b"") -> None:
    h = json.dumps(header, separators=(",", ":")).encode()
    sock.sendall(_U32.pack(len(h)) + h + _U64.pack(len(body)) + body)


def _recv_msg(sock: socket.socket) -> tuple[dict, bytes]:
    (hlen,) = _U32.unpack(_recv_exact(sock, 4))
    header = json.loads(_recv_exact(sock, hlen))
    (blen,) = _U64.unpack(_recv_exact(sock, 8))
    return header, (_recv_exact(sock, blen) if blen else b"")


def pack_frames(payloads: list[bytes]) -> bytes:
    return b"".join(_U32.pack(len(p)) + p for p in payloads)


def unpack_frames(body: bytes) -> list[bytes]:
    out, pos = [], 0
    while pos < len(body):
        (ln,) = _U32.unpack_from(body, pos)
        out.append(body[pos + 4 : pos + 4 + ln])
        pos += 4 + ln
    return out


class _Log:
    """One key's log: absolute offsets [base, base + len(payloads)), the
    oldest trimmed past ``maxlen``."""

    def __init__(self, maxlen: int) -> None:
        self.payloads: list[bytes] = []
        self.base = 0
        self.maxlen = maxlen
        self.cond = threading.Condition()
        self.bytes_appended = 0

    def append(self, payloads: list[bytes]) -> None:
        self.payloads.extend(payloads)
        self.bytes_appended += sum(len(p) for p in payloads)
        excess = len(self.payloads) - self.maxlen
        if excess > 0:
            del self.payloads[:excess]
            self.base += excess

    @property
    def end(self) -> int:
        return self.base + len(self.payloads)


class StreamHub:
    """A thread per connection over the per-key logs."""

    def __init__(self, host: str = "0.0.0.0", port: int = 0, persist_dir: str | None = None,
                 maxlen: int = 1_000_000):
        self._logs: dict[str, _Log] = {}
        self._logs_lock = threading.Lock()
        self._persist_lock = threading.Lock()
        self._maxlen = max(1, int(maxlen))
        self._persist_dir = Path(persist_dir) if persist_dir else None
        hub = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self) -> None:  # one connection, many requests
                sock = self.request
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                try:
                    while True:
                        header, body = _recv_msg(sock)
                        hub._dispatch(sock, header, body)
                except OSError:  # the peer went away (ConnectionError among them)
                    pass

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server((host, port), Handler)
        self.host, self.port = self._server.server_address[:2]
        self._thread: threading.Thread | None = None

    def _log_for(self, key: str) -> _Log:
        with self._logs_lock:
            log = self._logs.get(key)
            if log is None:
                log = self._logs[key] = _Log(self._maxlen)
            return log

    def _dispatch(self, sock: socket.socket, header: dict, body: bytes) -> None:
        op = header.get("op")
        if op == "append":
            log = self._log_for(header["key"])
            payloads = unpack_frames(body)
            with log.cond:
                log.append(payloads)
                log.cond.notify_all()
            if self._persist_dir is not None:
                self._persist(header["key"], payloads)
            _send_msg(sock, {"ok": 1})
        elif op == "read":
            log = self._log_for(header["key"])
            offset = int(header.get("offset", 0))
            max_n = int(header.get("max", 4096))
            deadline = time.monotonic() + float(header.get("wait_s", 0.0))
            with log.cond:
                while log.end <= offset:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    log.cond.wait(timeout=remaining)
                # a reader behind the trim resumes at the oldest entry kept
                offset = max(offset, log.base)
                start = offset - log.base
                chunk = log.payloads[start : start + max_n]
            _send_msg(sock, {"ok": 1, "offset": offset + len(chunk)}, pack_frames(chunk))
        elif op == "ping":
            _send_msg(sock, {"ok": 1})
        else:
            _send_msg(sock, {"ok": 0, "error": f"unknown op {op!r}"})

    def _persist(self, key: str, payloads: list[bytes]) -> None:
        path = self._persist_dir / f"{key}.scf"
        with self._persist_lock:  # two writers of one key append in hub order
            path.parent.mkdir(parents=True, exist_ok=True)
            for p in payloads:
                write_payload(path, p)

    def counters(self) -> dict[str, dict[str, int]]:
        """Per key: messages appended (``end``, trimmed ones included), bytes
        of their payloads, and messages still held."""
        with self._logs_lock:
            logs = dict(self._logs)
        out = {}
        for key, log in sorted(logs.items()):
            with log.cond:
                out[key] = {"messages": log.end, "bytes": log.bytes_appended, "held": len(log.payloads)}
        return out

    def start(self) -> None:
        assert self._thread is None
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True, name="stream-hub")
        self._thread.start()
        logger.info("Stream hub listening on %s:%d", self.host, self.port)

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


class _HubConnection:
    """One persistent client connection that reconnects on failure."""

    def __init__(self, addr: str):
        host, port = addr.rsplit(":", 1)
        self.addr = (host, int(port))
        self._sock: socket.socket | None = None
        self._lock = threading.Lock()

    def _connect(self) -> socket.socket:
        if self._sock is None:
            s = socket.create_connection(self.addr, timeout=60)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._sock = s
        return self._sock

    def request(self, header: dict, body: bytes = b"", retries: int = 3) -> tuple[dict, bytes]:
        with self._lock:
            last_err: Exception | None = None
            for attempt in range(retries):
                try:
                    sock = self._connect()
                    _send_msg(sock, header, body)
                    resp, rbody = _recv_msg(sock)
                    if not resp.get("ok"):
                        raise RuntimeError(f"hub error: {resp}")
                    return resp, rbody
                except OSError as e:  # ConnectionError and socket.timeout among them
                    last_err = e
                    self._close()
                    time.sleep(0.2 * (attempt + 1))
            raise ConnectionError(f"hub {self.addr} unreachable: {last_err}")

    def _close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def close(self) -> None:
        with self._lock:
            self._close()


def stream_key(spec) -> str:
    return f"{spec.topic}/{spec.instance}/{spec.partition}"


def wait_for_hub(addr: str, timeout: float = 60.0) -> None:
    """Block until the hub at ``addr`` answers a ping."""
    deadline = time.monotonic() + timeout
    conn = _HubConnection(addr)
    try:
        while True:
            try:
                conn.request({"op": "ping"}, retries=1)
                return
            except ConnectionError:
                if time.monotonic() > deadline:
                    raise TimeoutError(f"Stream hub {addr} failed to come up") from None
                time.sleep(0.5)
    finally:
        conn.close()


class TcpStreamWriter:
    def __init__(self, spec, hub_addr: str):
        self.spec = spec
        self._conn = _HubConnection(hub_addr)
        self._key = stream_key(spec)

    def write(self, msg: dict) -> None:
        self._conn.request({"op": "append", "key": self._key, "n": 1}, pack_frames([encode(msg)]))

    def close(self) -> None:
        self._conn.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class TcpStreamReader:
    """Tail-follow reader: ``read_available`` drains what the hub holds now;
    ``read`` long-polls (the hub holds a request up to ``poll_interval``
    when nothing is new, so idle tailing costs one round trip a poll)."""

    def __init__(self, spec, hub_addr: str, poll_interval: float = 0.05):
        self.spec = spec
        self.poll_interval = poll_interval
        self._conn = _HubConnection(hub_addr)
        self._key = stream_key(spec)
        self._offset = 0
        self._stop = threading.Event()

    def stop(self) -> None:
        self._stop.set()

    def read_available(self, max_messages: int | None = None, wait_s: float = 0.0):
        remaining = max_messages if max_messages is not None else 2**31
        while remaining > 0:
            resp, body = self._conn.request({"op": "read", "key": self._key, "offset": self._offset,
                                             "max": min(remaining, 4096), "wait_s": wait_s})
            payloads = unpack_frames(body)
            if not payloads:
                return
            self._offset = int(resp["offset"])
            for p in payloads:
                yield decode(p)
                remaining -= 1
            wait_s = 0.0  # long-poll only on the first round

    def read(self):
        while not self._stop.is_set():
            yield from self.read_available(wait_s=self.poll_interval)
