"""OpenAI-compatible HTTP server over the inference engine, on the stdlib.

Port of the JAX package's ``inference/server.py`` (aiohttp there; the card
host has no aiohttp). ``http.server.ThreadingHTTPServer`` speaks HTTP/1.1
with keep-alive; each connection has a thread, which waits on the engine's
future or, for SSE, on a queue the engine thread's stream callback fills.

- ``POST /v1/chat/completions``: the chat template applied here, content
  plus per-token logprobs, each token reported both as vLLM's
  ``token_id:<id>`` text and in a plain ``token_ids`` list. ``stream: true``
  sends ``chat.completion.chunk`` events, one per decode window, in chunked
  transfer encoding. With tools in the request a closed ``</tool_call>``
  ends generation, and the token stream is cut at the token that closes the
  tag (``_tool_close_boundary``);
- ``POST /v1/completions``: with ``echo`` and ``logprobs`` and
  ``max_tokens`` 0, the teacher-forced scores of the given ids
  (``score_tokens``); otherwise a plain completion;
- ``POST /receive_weight_update``: a PWT3 body (``application/x-msgpack``)
  through the engine's transfer thread, answered 200 once the engine serves
  the pushed version (504 after 600 s), or JSON ``{"checkpoint_dir"}`` for
  an HF directory. A ``frozen`` server (the KL reference) answers 403;
- ``GET /weight_version``, ``GET /health`` (with ``perf_counters``,
  ``push_counters`` and this process's kernel launch counts), ``GET /v1/models``, and ``GET /debug/param_checksums``,
  two integer sums of each weight's bits (the vision tower's under
  ``vision_tower/``), which a pusher compares with its own to show that a
  push landed bit for bit (a tp engine adds each rank's, of its slice,
  under ``ranks``). ``/health``'s ``last_push`` carries the push's
  mode ("blob", "blob-chunked", "double-buffer", "streamed") and, while a chunked
  push is in flight, its ``bytes_done``.
"""

from __future__ import annotations

import json
import logging
import queue
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable

import torch

from ..ops import kernel_launches
from .engine import GenRequest, SamplingParams
from .weight_transfer import flatten_params, tensor_bytes

logger = logging.getLogger(__name__)

SWAP_TIMEOUT_S = 600.0


def _tool_close_boundary(tokenizer, ids: list[int], n_calls: int) -> int:
    """Smallest prefix length of ``ids`` whose decoded text holds ``n_calls``
    closing ``</tool_call>`` tags; ``len(ids)`` if the decode never holds
    them (tokens that cannot be attributed past a tag are kept)."""
    close = "</tool_call>"

    def count(k: int) -> int:
        return tokenizer.decode(ids[:k], skip_special_tokens=True).count(close)

    if not ids or count(len(ids)) < n_calls:
        return len(ids)
    lo, hi = 1, len(ids)
    while lo < hi:
        mid = (lo + hi) // 2
        if count(mid) >= n_calls:
            hi = mid
        else:
            lo = mid + 1
    return lo


def param_checksum(t: torch.Tensor) -> list[int]:
    """Two sums over a tensor's raw bits, as 16-bit words: their plain sum
    and a position-weighted sum. Any single flipped bit changes the first."""
    words = tensor_bytes(t)
    if words.numel() % 2:
        words = torch.cat([words, words.new_zeros(1)])
    w = words.view(torch.int16).to(torch.int64)
    pos = torch.arange(w.numel(), device=w.device, dtype=torch.int64) % 65521 + 1
    return [int(w.sum()), int((w * pos).sum())]


def param_checksums(params: dict) -> dict[str, list[int]]:
    return {name: param_checksum(t) for name, t in flatten_params(params)}


class InferenceServer:
    def __init__(self, engine, tokenizer, model_name: str = "local", frozen: bool = False):
        self.engine = engine
        self.tokenizer = tokenizer
        self.model_name = model_name
        # frozen: the reference-policy server of the KL penalty; pushes are
        # refused so scoring always runs on the initial weights
        self.frozen = frozen
        self.httpd: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------------
    def start(self, host: str = "0.0.0.0", port: int = 8080) -> int:
        """Serve on a background thread; returns the bound port (``port`` 0
        binds a free one)."""
        self.httpd = _HTTPServer((host, port), _make_handler(self))
        self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True, name="http-server")
        self._thread.start()
        bound = self.httpd.server_address[1]
        logger.info("Inference server listening on %s:%d", host, bound)
        return bound

    def shutdown(self) -> None:
        if self.httpd is not None:
            self.httpd.shutdown()
            self.httpd.server_close()
            self.httpd = None

    # ------------------------------------------------------------------
    def health(self) -> dict:
        return {"status": "ok", "version": self.engine.version, "counters": self.engine.perf_counters(),
                "push": self.engine.push_counters(), "last_push": self.engine.last_push_timings,
                "kernel_launches": kernel_launches()}

    def weight_version(self) -> dict:
        return {"version": self.engine.version, **self.engine.push_counters()}

    def models(self) -> dict:
        return {"object": "list", "data": [{"id": self.model_name, "object": "model"}]}

    def checksums(self) -> dict:
        """The live weights' checksums; a tp engine's rank 0 adds every
        rank's, of its slice, under ``ranks``."""
        if getattr(self.engine, "tp", None) is not None:
            ranks = self.engine.rank_checksums()
            return {"version": self.engine.version, "checksums": ranks[0], "ranks": ranks}
        with torch.no_grad():
            return {"version": self.engine.version, "checksums": param_checksums(self.engine.live_tree())}

    @staticmethod
    def _sampling_params(body: dict) -> SamplingParams:
        return SamplingParams(
            temperature=float(body.get("temperature", 1.0)),
            top_p=float(body.get("top_p", 1.0)),
            top_k=int(body.get("top_k", 0) or 0),
            max_tokens=int(body.get("max_tokens", 256)),
            stop_token_ids=tuple(body.get("stop_token_ids", ())),
        )

    def prompt_ids(self, body: dict) -> list[int]:
        kwargs: dict[str, Any] = {"tools": body["tools"]} if body.get("tools") else {}
        return list(self.tokenizer.apply_chat_template(body["messages"], add_generation_prompt=True, **kwargs))

    def chat_completion(self, body: dict, prompt_ids: list[int]) -> tuple[int, dict]:
        gen = GenRequest(prompt_ids=prompt_ids, params=self._sampling_params(body), request_id=str(uuid.uuid4()))
        result = self.engine.submit(gen).result()
        if result.finish_reason == "abort":
            return 400, {"error": {"message": "prompt too long", "type": "invalid_request_error"}}
        content = self.tokenizer.decode(result.token_ids, skip_special_tokens=True)
        return 200, {
            "id": f"chatcmpl-{gen.request_id}",
            "object": "chat.completion",
            "created": int(time.time()),
            "model": self.model_name,
            "model_version": result.model_version_start,
            "choices": [{
                "index": 0,
                "message": {"role": "assistant", "content": content},
                "finish_reason": result.finish_reason,
                "logprobs": {"content": _logprob_entries(result.token_ids, result.logprobs)},
                "token_ids": [int(t) for t in result.token_ids],
            }],
            "usage": {"prompt_tokens": result.prompt_tokens, "completion_tokens": len(result.token_ids),
                      "total_tokens": result.prompt_tokens + len(result.token_ids)},
        }

    def chat_stream(self, body: dict, prompt_ids: list[int], emit: Callable[[bytes], None]) -> None:
        """SSE events through ``emit``: a role chunk, one chunk per decode
        window with its delta text, token ids and logprobs, a final chunk
        with finish_reason and usage, then ``[DONE]``."""
        events: queue.Queue = queue.Queue()
        request_id = str(uuid.uuid4())
        gen = GenRequest(prompt_ids=prompt_ids, params=self._sampling_params(body), request_id=request_id,
                         stream_callback=lambda t, lp, finish: events.put((list(t), list(lp), finish)))
        future = self.engine.submit(gen)
        created = int(time.time())
        all_ids: list[int] = []
        sent_text = ""

        def chunk(delta: dict, finish: str | None, extra: dict | None = None) -> bytes:
            obj = {"id": f"chatcmpl-{request_id}", "object": "chat.completion.chunk", "created": created,
                   "model": self.model_name,
                   "choices": [{"index": 0, "delta": delta, "finish_reason": finish, **(extra or {})}]}
            return f"data: {json.dumps(obj)}\n\n".encode()

        def final(finish: str, result) -> bytes:
            # usage counts the streamed ids: the truncated count when a tool
            # call closed the stream
            return chunk({}, finish, {
                "usage": {"prompt_tokens": result.prompt_tokens, "completion_tokens": len(all_ids),
                          "total_tokens": result.prompt_tokens + len(all_ids)},
                "model_version": result.model_version_start,
            })

        tool_parser = None
        if body.get("tools") and body.get("tool_choice") != "none":
            from .tool_parser import StreamingToolParser

            tool_parser = StreamingToolParser()
        try:
            emit(chunk({"role": "assistant", "content": ""}, None))
            while True:
                tokens, logprobs, finish = events.get()
                stop_for_tools = False
                if tokens:
                    all_ids.extend(tokens)
                    # decode the whole transcript and diff: a per-window
                    # decode would split multi-token glyphs
                    text = self.tokenizer.decode(all_ids, skip_special_tokens=True)
                    delta_text, sent_text = text[len(sent_text):], text
                    delta: dict = {"content": delta_text}
                    if tool_parser is not None:
                        content, new_calls = tool_parser.feed(delta_text)
                        delta = {"content": content} if content else {}
                        if new_calls:
                            # generation stops at the tag, so the text after
                            # it reaches clients no more than its tokens do
                            tail_txt = delta_text.rsplit("</tool_call>", 1)[-1]
                            if tail_txt and content.endswith(tail_txt):
                                content = content[: -len(tail_txt)]
                                delta = {"content": content} if content else {}
                            first = len(tool_parser.calls) - len(new_calls)
                            delta["tool_calls"] = [{"index": i, **c.to_dict()} for i, c in enumerate(new_calls, first)]
                            stop_for_tools = True
                            # cut the token stream exactly at the closing tag
                            boundary = _tool_close_boundary(self.tokenizer, all_ids, len(tool_parser.calls))
                            drop = len(all_ids) - boundary
                            if drop > 0:
                                tokens = tokens[: max(0, len(tokens) - drop)]
                                logprobs = logprobs[: len(tokens)]
                                del all_ids[boundary:]
                    emit(chunk(delta, None, {"token_ids": [int(t) for t in tokens],
                                             "logprobs": {"content": _logprob_entries(tokens, logprobs)}}))
                if stop_for_tools and finish is None:
                    # the first closed tool call frees the slot now
                    self.engine.abort(request_id)
                    emit(final("tool_calls", future.result()))
                    break
                if finish is not None:
                    result = future.result()
                    if tool_parser is not None:
                        # a partial tag or an unclosed block is released as text
                        tail = tool_parser.flush()
                        if tail:
                            emit(chunk({"content": tail}, None))
                        if tool_parser.calls:
                            finish = "tool_calls"
                    emit(final(finish, result))
                    break
            emit(b"data: [DONE]\n\n")
        finally:
            if not future.done():
                # the client went away mid-generation: free the slot
                self.engine.abort(request_id)

    def completions(self, body: dict) -> dict:
        prompt = body.get("prompt")
        token_ids = self.tokenizer.encode(prompt) if isinstance(prompt, str) else list(prompt)
        if body.get("echo") and body.get("logprobs") is not None and int(body.get("max_tokens", 0)) == 0:
            scores = self.engine.score_tokens(token_ids)
            return {
                "id": f"cmpl-{uuid.uuid4()}", "object": "text_completion", "model": self.model_name,
                "choices": [{
                    "index": 0, "text": "",
                    "logprobs": {"token_logprobs": [None] + [float(x) for x in scores],
                                 "tokens": [f"token_id:{t}" for t in token_ids]},
                    "finish_reason": "stop",
                }],
            }
        result = self.engine.submit(GenRequest(prompt_ids=token_ids, params=self._sampling_params(body))).result()
        return {
            "id": f"cmpl-{uuid.uuid4()}", "object": "text_completion", "model": self.model_name,
            "choices": [{
                "index": 0,
                "text": self.tokenizer.decode(result.token_ids, skip_special_tokens=True),
                "token_ids": [int(t) for t in result.token_ids],
                "logprobs": {"token_logprobs": [float(x) for x in result.logprobs]},
                "finish_reason": result.finish_reason,
            }],
        }

    def receive_pushed(self, body, read_s: float) -> tuple[int, dict]:
        """A PWT3 push: 200 once the engine serves its version. The reply
        times the body's read and the wait for the swap, and counts the
        decode windows read back from the body's arrival to the swap."""
        t0 = time.monotonic()
        try:
            version = self.engine.update_params_serialized(body)
        except ValueError as exc:  # a tree that does not fit, or over budget
            return 400, {"error": str(exc)}
        deadline = t0 + SWAP_TIMEOUT_S
        while self.engine.version < version and time.monotonic() < deadline:
            time.sleep(0.005)
        if self.engine.version < version:
            return 504, {"error": f"weight swap did not land within {SWAP_TIMEOUT_S:.0f}s"}
        t1 = time.monotonic()
        return 200, {"status": "ok", "version": version, "read_s": read_s, "wait_s": t1 - t0,
                     "push_span": self.engine.window_gaps(t0 - read_s, t1)}

    def receive_checkpoint(self, body: dict) -> dict:
        """An HF checkpoint directory, loaded onto the engine's device and
        swapped in between windows."""
        from ..models.hf_loader import load_hf_model

        version = int(body.get("version", self.engine.version + 1))
        params, _ = load_hf_model(body["checkpoint_dir"], dtype=self.engine.model_cfg.dtype, device=self.engine.device)
        self.engine.update_params(params, version)
        return {"status": "ok", "version": version}


def _logprob_entries(token_ids, logprobs) -> list[dict]:
    # vLLM's --return-tokens-as-token-ids convention, plus the id itself
    return [{"token": f"token_id:{t}", "token_id": int(t), "logprob": float(lp)} for t, lp in zip(token_ids, logprobs)]


class _HTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    # a burst of concurrent clients (a GRPO group, an actor's whole batch)
    # must not overflow the listen backlog
    request_queue_size = 1024


def _make_handler(server: InferenceServer) -> type:
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # noqa: D102 - quiet access log
            logger.debug("%s " + fmt, self.address_string(), *args)

        # -- plumbing ---------------------------------------------------
        def _read_body(self) -> tuple[Any, float]:
            n = int(self.headers.get("Content-Length") or 0)
            t0 = time.monotonic()
            # a weight push lands in memory that is not zero-filled first:
            # filling a gigabyte holds the GIL, and the engine thread with it
            if self.headers.get_content_type() == "application/x-msgpack":
                body = torch.empty(n, dtype=torch.uint8).numpy()
            else:
                body = bytearray(n)
            view, got = memoryview(body), 0
            while got < n:
                k = self.rfile.readinto(view[got:])
                if not k:
                    raise ConnectionError("client closed mid-body")
                got += k
            return body, time.monotonic() - t0

        def _send_json(self, status: int, obj: dict) -> None:
            data = json.dumps(obj).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _send_chunked(self, data: bytes) -> None:
            self.wfile.write(b"%x\r\n%s\r\n" % (len(data), data))
            self.wfile.flush()

        # -- routes -----------------------------------------------------
        def do_GET(self):  # noqa: N802 - http.server's naming
            routes = {"/health": server.health, "/weight_version": server.weight_version,
                      "/v1/models": server.models, "/debug/param_checksums": server.checksums}
            fn = routes.get(self.path.split("?")[0])
            if fn is None:
                self._send_json(404, {"error": f"no route {self.path}"})
                return
            self._send_json(200, fn())

        def do_POST(self):  # noqa: N802
            body, read_s = self._read_body()
            path = self.path.split("?")[0]
            try:
                if path == "/receive_weight_update":
                    if server.frozen:
                        self._send_json(403, {"error": "frozen reference-policy server rejects weight updates"})
                    elif self.headers.get_content_type() == "application/x-msgpack":
                        self._send_json(*server.receive_pushed(body, read_s))
                    else:
                        self._send_json(200, server.receive_checkpoint(json.loads(body)))
                elif path == "/v1/chat/completions":
                    self._chat(json.loads(body))
                elif path == "/v1/completions":
                    self._send_json(200, server.completions(json.loads(body)))
                else:
                    self._send_json(404, {"error": f"no route {self.path}"})
            except (BrokenPipeError, ConnectionResetError):
                self.close_connection = True

        def _chat(self, body: dict) -> None:
            prompt_ids = server.prompt_ids(body)
            if not body.get("stream"):
                self._send_json(*server.chat_completion(body, prompt_ids))
                return
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            server.chat_stream(body, prompt_ids, self._send_chunked)
            self.wfile.write(b"0\r\n\r\n")
            self.wfile.flush()

    return Handler
