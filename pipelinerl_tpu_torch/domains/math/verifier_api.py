"""Math verifier environment server and its RPC client.

Port of the JAX package's ``domains/math/verifier_api.py`` on the stdlib
(``utils/http_json.py``; the card host has no aiohttp), answering as JAX's
server does: ``POST /verify_answer`` ``{prediction, gold, strict}`` →
``{answer_status}`` (a countdown problem sends ``numbers`` and ``target``
instead of ``gold``; a verification that raises answers ``unparsable``),
and ``GET /health``.
"""

from __future__ import annotations

import logging
from typing import Any

from ...utils.http_json import JsonServer
from .verifier import UNPARSABLE, grade_answer, verify_countdown

logger = logging.getLogger(__name__)


class MathEnvironment(JsonServer):
    """The environment-server job of the math domain."""

    def __init__(self) -> None:
        super().__init__({("POST", "/verify_answer"): self.verify_answer}, name="math-verifier")

    def verify_answer(self, body: dict, query: dict) -> tuple[int, dict]:
        try:
            if "numbers" in body and "target" in body:  # a countdown problem
                status = verify_countdown(body["prediction"], list(body["numbers"]), int(body["target"]))
            else:
                status = grade_answer(body["prediction"], str(body["gold"]), bool(body.get("strict", True)))
        except Exception:  # noqa: BLE001 - JAX's server answers unparsable
            logger.exception("Verification crashed")
            status = UNPARSABLE
        return 200, {"answer_status": status}


async def verify_answer_rpc(session: Any, host: str, port: int, prediction: str, gold: str, strict: bool = True,
                            extra: dict[str, Any] | None = None) -> str:
    body = {"prediction": prediction, "gold": gold, "strict": strict}
    if extra:
        body.update(extra)
    async with session.post(f"http://{host}:{port}/verify_answer", json=body) as resp:
        resp.raise_for_status()
        data = await resp.json()
    return data["answer_status"]
