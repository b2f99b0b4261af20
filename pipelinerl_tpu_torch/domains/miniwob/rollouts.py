"""MiniWoB rollout: a multi-turn observation → action loop over a web task,
and the reference's two reward computations.

Port of the JAX package's ``domains/miniwob/rollouts.py``: the episode runs
on a pool of web-environment servers (``_RemoteEnv`` over
``environment_server.py``, with health checks and failover) where
``cfg.environment`` names them, and on the
simulated environment in process (``_LocalEnv``) otherwise.
``_failed_rollout`` is the penalized empty result when every server fails.
"""

from __future__ import annotations

import asyncio
import logging
import random
import re
import time
from dataclasses import dataclass
from typing import Any

from ...inference.client import BaseLLM, Prompt, llm_async_generate, make_training_text
from ...types import BaseMetrics, RolloutResult, rollout_has_overflow
from ..servers import rollout_servers
from .simulated_env import SimulatedWebEnv

logger = logging.getLogger(__name__)

DOMAIN = "miniwob"

SYSTEM_PROMPT = (
    "You control a web page. Each turn you see the goal and the page DOM "
    "with element ids in [brackets]. Reply with EXACTLY ONE action:\n"
    'click("bid")\nfill("bid", "text")\nselect_option("bid", "option")\n'
)

_ACTION_LINE_RE = re.compile(r"(click|fill|select_option)\s*\(.*?\)", re.DOTALL)


@dataclass
class MiniwobMetrics(BaseMetrics):
    overflow: bool = False
    n_llm_calls: int = 0
    n_step_errors: int = 0
    n_page_observations: int = 0
    n_steps: int = 0
    total_execution_time: float = 0.0


def compute_reward(raw_reward: float, no_error: bool, n_step_errors: int, n_page_observations: int,
                   mode: str) -> float:
    """``nico``: the raw reward discounted by 0.99 per step error, or -1 on
    an error or a failed task; ``uic``: ±1 discounted by 0.98 per page
    observation."""
    if mode == "nico":
        return raw_reward * 0.99**n_step_errors if no_error and raw_reward >= 0 else -1.0
    if mode == "uic":
        reward = float(raw_reward > 0)
        if reward == 0.0:
            reward = -1.0
        return reward * 0.98**n_page_observations
    raise ValueError(f"invalid reward_computation {mode!r}")


async def check_env_server_health(session: Any, host: str, port: int) -> bool:
    try:
        async with session.get(f"http://{host}:{port}/health", timeout=5) as response:
            return response.status == 200
    except Exception:  # noqa: BLE001 - any failure marks the server unhealthy
        logger.warning("health check failed for %s:%d", host, port, exc_info=True)
        return False


async def generate_miniwob_rollout(cfg: Any, llm: BaseLLM, problem: dict, session: Any = None) -> RolloutResult:
    """An episode on a web-environment server where ``cfg.environment`` names
    servers, else on the simulated env in process. Servers are tried in random order, skipping unhealthy ones and
    bounding each attempt by ``actor.rollout_timeout``; when every server
    fails, the penalized ``_failed_rollout``."""
    start_time = time.time()
    actor_cfg = cfg.actor if hasattr(cfg, "actor") else cfg
    rollout_timeout = float(actor_cfg.get("rollout_timeout", 600))
    servers = rollout_servers(cfg, session)
    if not servers:
        return await _run_episode(cfg, llm, problem, session, start_time, None)
    tried: list[tuple[str, int]] = []
    while len(tried) < len(servers):
        host, port = random.choice([s for s in servers if s not in tried])
        tried.append((host, port))
        if not await check_env_server_health(session, host, port):
            logger.warning("env server %s:%d unhealthy; rotating", host, port)
            continue
        try:
            return await asyncio.wait_for(_run_episode(cfg, llm, problem, session, start_time, (host, port)),
                                          timeout=rollout_timeout)
        except asyncio.TimeoutError:
            logger.warning("rollout timed out on %s:%d; rotating", host, port)
        except Exception:  # noqa: BLE001 - the next server may run it
            logger.warning("rollout failed on %s:%d; rotating", host, port, exc_info=True)
    logger.error("all %d env servers failed for %s", len(servers), problem.get("task"))
    return _failed_rollout(problem, start_time)


class _RemoteEnv:
    def __init__(self, session: Any, host: str, port: int):
        self.session = session
        self.base = f"http://{host}:{port}"
        self.sid: str | None = None

    async def start(self, task: str, seed: int) -> str:
        async with self.session.post(f"{self.base}/start_task", json={"task": task, "seed": seed}) as r:
            body = await r.json()
            if r.status != 200:
                raise RuntimeError(f"start_task failed: {body}")
            self.sid = body["session_id"]
            return body["observation"]

    async def step(self, action: str) -> tuple[str, bool, dict]:
        async with self.session.post(f"{self.base}/step", json={"session_id": self.sid, "action": action}) as r:
            body = await r.json()
            if r.status != 200:
                raise RuntimeError(f"step failed: {body}")
            return body["observation"], body["done"], body.get("info", {})

    async def close(self) -> None:
        if self.sid:
            try:
                await self.session.post(f"{self.base}/close", json={"session_id": self.sid})
            except Exception:  # noqa: BLE001 - closing is best effort, as in JAX
                pass


class _LocalEnv:
    def __init__(self) -> None:
        self.env: SimulatedWebEnv | None = None

    async def start(self, task: str, seed: int) -> str:
        self.env = SimulatedWebEnv(task_name=task, seed=seed)
        return self.env.observe()

    async def step(self, action: str) -> tuple[str, bool, dict]:
        return self.env.step(action)

    async def close(self) -> None:
        pass


async def _run_episode(cfg: Any, llm: BaseLLM, problem: dict, session: Any, start_time: float,
                       server: tuple[str, int] | None) -> RolloutResult:
    actor_cfg = cfg.actor if hasattr(cfg, "actor") else cfg
    max_loops = int(actor_cfg.get("agent_max_loops", 8))
    reward_mode = str(actor_cfg.get("reward_computation", "nico"))

    env = _RemoteEnv(session, *server) if server else _LocalEnv()
    observation = await env.start(problem["task"], int(problem.get("seed", 0)))

    messages = [
        {"role": "system", "content": actor_cfg.get("system_prompt") or SYSTEM_PROMPT},
        {"role": "user", "content": observation},
    ]
    llm_calls = []
    n_step_errors = 0
    n_page_observations = 1
    raw_reward = -1.0
    done = False
    try:
        for _loop in range(max_loops):
            llm_call = await llm_async_generate(llm, Prompt(messages=list(messages)), session)
            llm_calls.append(llm_call)
            content = llm_call.output.content or ""
            messages.append({"role": "assistant", "content": content})
            m = _ACTION_LINE_RE.search(content)
            action = m.group(0) if m else content.strip()
            if not m:
                n_step_errors += 1
            observation, done, info = await env.step(action)
            if info.get("action_error"):
                n_step_errors += 1
            n_page_observations += 1
            raw_reward = float(info.get("task_info", {}).get("REWARD_GLOBAL", raw_reward))
            if done:
                break
            messages.append({"role": "user", "content": observation})
    finally:
        await env.close()

    no_error = done and raw_reward >= 0
    reward = compute_reward(raw_reward, no_error, n_step_errors, n_page_observations, reward_mode)
    traces = [make_training_text(llm, call) for call in llm_calls]
    for t in traces:
        t.reward = reward
    metrics = MiniwobMetrics(
        reward=reward,
        success=reward > 0.5,
        no_error=no_error,
        no_answer=raw_reward < 0,
        overflow=rollout_has_overflow(traces),
        n_llm_calls=len(llm_calls),
        n_step_errors=n_step_errors,
        n_page_observations=n_page_observations,
        n_steps=len(llm_calls) + n_page_observations,
        total_execution_time=time.time() - start_time,
    )
    return RolloutResult(training_texts=traces, metrics=metrics, latency=time.time() - start_time,
                         dataset_name=problem.get("dataset"), domain=DOMAIN)


def _failed_rollout(problem: dict, start_time: float) -> RolloutResult:
    """Every server down: a penalized result with no training texts."""
    latency = time.time() - start_time
    metrics = MiniwobMetrics(reward=-1.0, success=False, no_error=False, no_answer=True,
                             total_execution_time=latency)
    return RolloutResult(training_texts=[], metrics=metrics, latency=latency, dataset_name=problem.get("dataset"),
                         domain=DOMAIN)
