"""Code execution backends for the TIR and coding rollouts.

Port of the JAX package's ``domains/tir/sandbox.py``:

- ``SandboxFusionClient``: POST ``/run_code`` to a SandboxFusion-compatible
  service, over ``urllib`` in the event loop's executor (the card host has
  no aiohttp), with the JAX client's request body, its parsing of
  ``run_result`` and ``status``, and its ``[execution error: ...]`` text on a
  transport error.
- ``safe_expression_executor``: the hermetic backend. It evaluates
  arithmetic expressions with the math verifier's ``_safe_eval`` and runs no
  code.

Both apply the code-safety blocklist before anything leaves the process.
"""

from __future__ import annotations

import asyncio
import json
import re
import urllib.request
from typing import Any

from ..math.verifier import _safe_eval

BLOCKED_PATTERNS = [
    re.compile(r"\bsys\.exit\b"),
    re.compile(r"\bos\._exit\b"),
    re.compile(r"\bos\.system\b"),
    re.compile(r"\bsubprocess\b"),
    re.compile(r"\bos\.popen\b"),
    re.compile(r"\bos\.exec\w*\b"),
    re.compile(r"\bos\.spawn\w*\b"),
    re.compile(r"\bos\.kill\b"),
    re.compile(r"\bshutil\.rmtree\b"),
    re.compile(r"\bos\.remove\b"),
    re.compile(r"\bos\.unlink\b"),
]


def check_code_safety(code: str) -> str | None:
    for pattern in BLOCKED_PATTERNS:
        if pattern.search(code):
            return f"Blocked: code contains forbidden pattern '{pattern.pattern}'"
    return None


class SandboxFusionClient:
    """POST /run_code against a SandboxFusion service."""

    def __init__(self, endpoint: str, timeout: float = 30.0):
        self.endpoint = endpoint.rstrip("/")
        self.timeout = timeout

    def _post(self, body: dict) -> dict:
        request = urllib.request.Request(f"{self.endpoint}/run_code", data=json.dumps(body).encode(),
                                         headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(request, timeout=self.timeout + 10) as resp:
            return json.loads(resp.read())

    async def execute(self, code: str, session: Any = None) -> str:
        """The run's output as the JAX client formats it; ``session`` is
        accepted for the JAX signature and not used."""
        rejection = check_code_safety(code)
        if rejection is not None:
            return rejection
        body = {"code": code, "language": "python", "run_timeout": self.timeout}
        try:
            data = await asyncio.get_running_loop().run_in_executor(None, self._post, body)
        except Exception as exc:  # noqa: BLE001 - any transport error becomes the run's text
            return f"[execution error: {exc}]"
        run = data.get("run_result") or {}
        parts = []
        if run.get("stdout"):
            parts.append(str(run["stdout"]).rstrip())
        if run.get("stderr"):
            parts.append(f"[stderr]\n{str(run['stderr']).rstrip()}")
        status = str(data.get("status", "")).lower()
        if "timeout" in status or "timeout" in str(data.get("message", "")).lower():
            parts.append("[execution timed out]")
        if not parts:
            parts.append("[no output]")
        return "\n".join(parts)


async def safe_expression_executor(code: str, session: Any = None) -> str:
    """Evaluate ``print(<arithmetic>)`` lines and bare expressions without
    running any code: the hermetic backend. Only printed values show."""
    rejection = check_code_safety(code)
    if rejection is not None:
        return rejection
    lines = [line.strip() for line in code.strip().splitlines() if line.strip()]
    outputs = []
    for line in lines:
        m = re.fullmatch(r"print\((.*)\)", line)
        expr = m.group(1) if m else line
        val = _safe_eval(expr)
        if val is not None and m:
            outputs.append(str(int(val)) if float(val).is_integer() else str(val))
    return "\n".join(outputs) if outputs else "[no output]"
