"""Tool-call extraction from generated text.

Port of the JAX package's ``domains/tir/tool_parser.py``: ``parse_tool_calls``
pulls every ``<tool_call>{json}</tool_call>`` block (and the
``<tool_calls>[...]`` variant) out of a finished completion, as the
function-calling domain grades it; ``StreamingToolParser`` holds tool blocks
and partial tags out of the server's SSE content stream and reports each
call the moment its closing tag arrives, which is where the server stops
generation.
"""

from __future__ import annotations

import json
import re
import uuid
from dataclasses import dataclass, field


@dataclass
class ToolFunction:
    name: str
    arguments: str  # a JSON string, as the OpenAI wire format has it


@dataclass
class ToolCall:
    function: ToolFunction
    id: str = field(default_factory=lambda: f"call_{uuid.uuid4().hex[:8]}")
    type: str = "function"

    def to_dict(self) -> dict:
        return {"id": self.id, "type": self.type,
                "function": {"name": self.function.name, "arguments": self.function.arguments}}


def _call_from_obj(obj: dict) -> ToolCall | None:
    if not isinstance(obj, dict):
        return None
    name = obj.get("name") or (obj.get("function") or {}).get("name")
    if not name:
        return None
    args = obj.get("arguments", (obj.get("function") or {}).get("arguments", {}))
    if not isinstance(args, str):
        args = json.dumps(args)
    return ToolCall(function=ToolFunction(name=str(name), arguments=args))


_TOOL_CALL_RE = re.compile(r"<tool_call>\s*(.*?)\s*</tool_call>", re.S)
_TOOL_CALLS_RE = re.compile(r"<tool_calls>\s*(.*?)\s*</tool_calls>", re.S)
_FINAL_RESPONSE_RE = re.compile(r"\[BEGIN FINAL RESPONSE\](.*?)(?:\[END FINAL RESPONSE\]|$)", re.S)


def parse_tool_calls(text: str) -> tuple[list[ToolCall], str]:
    """→ (tool calls, the content without its tool blocks; the
    ``[BEGIN FINAL RESPONSE]`` section's text where there is one)."""
    calls: list[ToolCall] = []
    for raw in _TOOL_CALL_RE.findall(text):
        try:
            obj = json.loads(raw)
        except json.JSONDecodeError:
            continue
        call = _call_from_obj(obj)
        if call:
            calls.append(call)
    for raw in _TOOL_CALLS_RE.findall(text):
        try:
            arr = json.loads(raw)
        except json.JSONDecodeError:
            continue
        if isinstance(arr, list):
            for obj in arr:
                call = _call_from_obj(obj)
                if call:
                    calls.append(call)
    content = _TOOL_CALLS_RE.sub("", _TOOL_CALL_RE.sub("", text))
    final = _FINAL_RESPONSE_RE.search(content)
    if final:
        content = final.group(1)
    return calls, content.strip()


class StreamingToolParser:
    """Feed each text delta; get back the content that is safe to emit and
    the tool calls whose closing tag this delta completed."""

    _OPEN = "<tool_call>"
    _CLOSE = "</tool_call>"

    def __init__(self) -> None:
        self._buf = ""
        self._in_call = False
        self.calls: list[ToolCall] = []

    def feed(self, delta: str) -> tuple[str, list[ToolCall]]:
        self._buf += delta
        content: list[str] = []
        new_calls: list[ToolCall] = []
        while True:
            if self._in_call:
                end = self._buf.find(self._CLOSE)
                if end == -1:
                    break  # wait for the closing tag
                raw, self._buf = self._buf[:end], self._buf[end + len(self._CLOSE):]
                self._in_call = False
                try:
                    call = _call_from_obj(json.loads(raw.strip()))
                except json.JSONDecodeError:
                    call = None
                if call:
                    new_calls.append(call)
                    self.calls.append(call)
                continue
            start = self._buf.find(self._OPEN)
            if start != -1:
                content.append(self._buf[:start])
                self._buf = self._buf[start + len(self._OPEN):]
                self._in_call = True
                continue
            # hold back a trailing partial "<tool_call" prefix
            hold = next((h for h in range(min(len(self._buf), len(self._OPEN) - 1), 0, -1)
                         if self._OPEN.startswith(self._buf[-h:])), 0)
            content.append(self._buf[:-hold] if hold else self._buf)
            self._buf = self._buf[-hold:] if hold else ""
            break
        return "".join(content), new_calls

    def flush(self) -> str:
        """End of stream: what is still buffered, an unclosed block as plain
        text with its tag."""
        out = (self._OPEN + self._buf) if self._in_call else self._buf
        self._buf, self._in_call = "", False
        return out
