"""Web-environment server: sessions over the simulated web tasks.

Port of the JAX package's ``domains/miniwob/environment_server.py`` on the
stdlib (``utils/http_json.py``), answering as JAX's server does:
``POST /start_task`` ``{task, seed}`` → ``{session_id, observation}`` (503
at ``max_sessions``, 400 for a task it cannot start); ``POST /step``
``{session_id, action}`` → ``{observation, done, info}`` (404 for an unknown
session; a finished episode closes its session); ``POST /close``
``{session_id}`` → ``{closed}``; ``GET /health`` → ``{status, backend,
active_sessions}``. The backend is the port's ``simulated_env``; BrowserGym
stays gated off, as in JAX (where it is installed JAX's server uses it; the
card host has none).
"""

from __future__ import annotations

import logging
import threading
import uuid

from ...utils.http_json import JsonServer
from .simulated_env import SimulatedWebEnv

logger = logging.getLogger(__name__)


class WebEnvironmentServer(JsonServer):
    def __init__(self, max_sessions: int = 32) -> None:
        super().__init__({("POST", "/start_task"): self.start_task, ("POST", "/step"): self.step,
                          ("POST", "/close"): self.close_session}, name="web-environment")
        self.sessions: dict[str, SimulatedWebEnv] = {}
        self.max_sessions = max_sessions
        self.backend = "simulated"
        self._lock = threading.Lock()  # the handlers run on one thread per connection

    def health(self) -> dict:
        return {"status": "ok", "backend": self.backend, "active_sessions": len(self.sessions)}

    def start_task(self, body: dict, query: dict) -> tuple[int, dict]:
        with self._lock:
            if len(self.sessions) >= self.max_sessions:
                return 503, {"error": "server at capacity"}
        try:
            session = SimulatedWebEnv(task_name=body["task"], seed=int(body.get("seed", 0)))
        except Exception as e:  # noqa: BLE001 - JAX's server answers 400 with the error
            logger.exception("failed to start task")
            return 400, {"error": str(e)}
        sid = uuid.uuid4().hex
        with self._lock:
            self.sessions[sid] = session
        return 200, {"session_id": sid, "observation": session.observe()}

    def step(self, body: dict, query: dict) -> tuple[int, dict]:
        sid = body.get("session_id", "")
        with self._lock:
            session = self.sessions.get(sid)
        if session is None:
            return 404, {"error": "no such session"}
        try:
            obs, done, info = session.step(body.get("action", ""))
        except Exception as e:  # noqa: BLE001 - JAX's server answers 500 with the error
            logger.exception("step failed")
            return 500, {"error": str(e)}
        if done:
            with self._lock:
                self.sessions.pop(sid, None)
        return 200, {"observation": obs, "done": done, "info": info}

    def close_session(self, body: dict, query: dict) -> tuple[int, dict]:
        with self._lock:
            session = self.sessions.pop(body.get("session_id", ""), None)
        return 200, {"closed": session is not None}
