"""HTTP LLM client: ``InProcessLLM``'s interface over the engine server.

Port of the JAX package's ``inference/http_client.py`` on the stdlib (the
card host has no aiohttp): each call opens one ``asyncio`` connection, sends
an HTTP/1.1 request and reads a ``Content-Length`` or chunked reply. It
parses the native ``token_ids`` field and, from servers that lack it,
vLLM's ``token_id:<id>`` logprob text. Importing it loads no engine and no
kernel, so host-only stages can use it.
"""

from __future__ import annotations

import asyncio
import json
import time
from typing import Any, AsyncIterator, Sequence
from urllib.parse import urlsplit

from .client import BaseLLM, LLMCall, LLMMessage, Prompt


class HTTPStatusError(RuntimeError):
    def __init__(self, status: int, body: bytes):
        super().__init__(f"HTTP {status}: {body[:500]!r}")
        self.status = status


def parse_token_id(token: str) -> int:
    if token.startswith("token_id:"):
        return int(token[len("token_id:"):])
    raise ValueError(f"Token not in token_id:<id> format: {token!r}")


async def _open(url: str, method: str, path: str, payload: bytes | None, content_type: str):
    """Send one request; → (reader, writer, status, headers)."""
    parts = urlsplit(url)
    reader, writer = await asyncio.open_connection(parts.hostname, parts.port or 80)
    head = [f"{method} {path} HTTP/1.1", f"Host: {parts.netloc}", "Connection: close"]
    if payload is not None:
        head += [f"Content-Type: {content_type}", f"Content-Length: {len(payload)}"]
    writer.write(("\r\n".join(head) + "\r\n\r\n").encode() + (payload or b""))
    await writer.drain()
    status_line = await reader.readline()
    if not status_line:
        writer.close()
        raise ConnectionError(f"{url}{path}: the server closed the connection")
    status = int(status_line.split()[1])
    headers = {}
    while True:
        line = await reader.readline()
        if line in (b"\r\n", b"\n", b""):
            break
        key, _, value = line.decode("latin-1").partition(":")
        headers[key.strip().lower()] = value.strip()
    return reader, writer, status, headers


async def _body_chunks(reader: asyncio.StreamReader, headers: dict) -> AsyncIterator[bytes]:
    if headers.get("transfer-encoding", "").lower() == "chunked":
        while True:
            size = int((await reader.readline()).split(b";")[0].strip() or b"0", 16)
            if size == 0:
                await reader.readline()
                return
            yield await reader.readexactly(size)
            await reader.readexactly(2)  # the chunk's CRLF
    elif "content-length" in headers:
        yield await reader.readexactly(int(headers["content-length"]))
    else:
        yield await reader.read()


async def request_json(url: str, path: str, body: dict | None = None, timeout: float | None = None) -> Any:
    """One JSON request (POST with ``body``, else GET); raises
    ``HTTPStatusError`` on a status of 400 or more."""

    async def go():
        payload = None if body is None else json.dumps(body).encode()
        reader, writer, status, headers = await _open(url, "GET" if body is None else "POST", path, payload,
                                                      "application/json")
        try:
            data = b"".join([c async for c in _body_chunks(reader, headers)])
        finally:
            writer.close()
        if status >= 400:
            raise HTTPStatusError(status, data)
        return json.loads(data)

    return await asyncio.wait_for(go(), timeout)


class HTTPLLM(BaseLLM):
    def __init__(self, base_url: str, tokenizer, parameters: dict | None = None, model_name: str = "local",
                 request_timeout: float = 3600.0):
        self.base_url = base_url.rstrip("/")
        self.tokenizer = tokenizer
        self.parameters = dict(parameters or {})
        self.model_name = model_name
        self.timeout = request_timeout

    def _chat_body(self, prompt: Prompt, overrides: dict, stream: bool = False) -> dict:
        body = {"model": self.model_name, "messages": prompt.messages, "logprobs": 1,
                **({"stream": True} if stream else {}), **self.parameters, **overrides}
        if prompt.tools:
            body["tools"] = prompt.tools
        return body

    async def agenerate(self, prompt: Prompt, session: Any = None, **overrides) -> LLMCall:
        start = time.monotonic()
        data = await request_json(self.base_url, "/v1/chat/completions", self._chat_body(prompt, overrides),
                                  self.timeout)
        choice = data["choices"][0]
        entries = choice["logprobs"]["content"]
        if "token_ids" in choice:
            token_ids = [int(t) for t in choice["token_ids"]]
        else:  # a vLLM-style reply
            token_ids = [parse_token_id(e["token"]) for e in entries]
        kwargs = {"tools": prompt.tools} if prompt.tools else {}
        prompt_ids = list(self.tokenizer.apply_chat_template(prompt.messages, add_generation_prompt=True, **kwargs))
        return LLMCall(
            prompt=prompt,
            output=LLMMessage(role="assistant", content=choice["message"].get("content")),
            prompt_token_ids=prompt_ids,
            output_token_ids=token_ids,
            logprobs=[float(e["logprob"]) for e in entries],
            finish_reason=choice.get("finish_reason", "stop"),
            model_version_start=data.get("model_version", 0),
            model_version_end=data.get("model_version", 0),
            latency=time.monotonic() - start,
        )

    async def astream(self, prompt: Prompt, session: Any = None, **overrides):
        """``stream: true`` generation: yields ``(token_ids, logprobs,
        text_delta, finish_reason)`` per SSE event; the last has
        ``finish_reason`` set."""
        payload = json.dumps(self._chat_body(prompt, overrides, stream=True)).encode()
        reader, writer, status, headers = await asyncio.wait_for(
            _open(self.base_url, "POST", "/v1/chat/completions", payload, "application/json"), self.timeout)
        try:
            if status >= 400:
                raise HTTPStatusError(status, b"".join([c async for c in _body_chunks(reader, headers)]))
            pending = b""
            async for chunk in _body_chunks(reader, headers):
                pending += chunk
                *lines, pending = pending.split(b"\n")
                for raw in lines:
                    line = raw.decode().strip()
                    if not line.startswith("data: "):
                        continue
                    payload_text = line[len("data: "):]
                    if payload_text == "[DONE]":
                        return
                    choice = json.loads(payload_text)["choices"][0]
                    entries = (choice.get("logprobs") or {}).get("content", [])
                    yield ([int(t) for t in choice.get("token_ids", [])], [float(e["logprob"]) for e in entries],
                           choice.get("delta", {}).get("content") or "", choice.get("finish_reason"))
        finally:
            writer.close()

    async def ascore(self, token_ids: Sequence[int]) -> list[float]:
        body = {"model": self.model_name, "prompt": list(token_ids), "echo": True, "logprobs": 1, "max_tokens": 0}
        data = await request_json(self.base_url, "/v1/completions", body, self.timeout)
        return [float(x) for x in data["choices"][0]["logprobs"]["token_logprobs"][1:]]
