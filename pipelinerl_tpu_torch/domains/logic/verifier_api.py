"""Logic verifier environment server and its RPC client.

Port of the JAX package's ``domains/logic/verifier_api.py`` on the stdlib
(``utils/http_json.py``): ``POST /verify_answer`` ``{prediction,
reward_context}`` → ``{answer_status}``, and ``GET /health``. A
verification runs on a worker thread and answers ``unparsable`` when it
raises or outlasts ``VERIFY_TIMEOUT_S`` (the worker then finishes on its
own, as in JAX's executor).
"""

from __future__ import annotations

import logging
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as FutureTimeout
from typing import Any

from ...utils.http_json import JsonServer
from .verifiers import UNPARSABLE, verify_answer

logger = logging.getLogger(__name__)

VERIFY_TIMEOUT_S = 5.0


class LogicEnvironment(JsonServer):
    def __init__(self) -> None:
        super().__init__({("POST", "/verify_answer"): self.verify_answer}, name="logic-verifier")
        self._pool = ThreadPoolExecutor(max_workers=8, thread_name_prefix="logic-verify")

    def verify_answer(self, body: dict, query: dict) -> tuple[int, dict]:
        future = self._pool.submit(verify_answer, body.get("prediction", ""), body.get("reward_context") or {})
        try:
            status = future.result(timeout=VERIFY_TIMEOUT_S)
        except FutureTimeout:
            logger.warning("logic verification timed out")
            status = UNPARSABLE
        except Exception:  # noqa: BLE001 - JAX's server answers unparsable
            logger.exception("logic verification crashed")
            status = UNPARSABLE
        return 200, {"answer_status": status}

    def shutdown(self) -> None:
        super().shutdown()
        self._pool.shutdown(wait=False, cancel_futures=True)


async def verify_answer_rpc(session: Any, host: str, port: int, prediction: str, reward_context: dict) -> str:
    async with session.post(f"http://{host}:{port}/verify_answer",
                            json={"prediction": prediction, "reward_context": reward_context}) as response:
        if response.status != 200:
            raise ValueError(f"verifier error {response.status}: {await response.text()}")
        return (await response.json())["answer_status"]
