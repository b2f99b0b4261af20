"""Math rollout generation with the 8-way reward table and length shaping.

Port of the JAX package's ``domains/math/rollouts.py``: the (answer_status
x finished) reward table, a discount by output length, and the overlong
penalty inside the last ``buffer_tokens`` of the budget. Verification runs
in process. A config that names verifier servers (``environment``) raises:
the environment servers and their RPC wait for ROADMAP Queue 1 item 5.
"""

from __future__ import annotations

import asyncio
import dataclasses
import time
from dataclasses import dataclass
from typing import Any

from ...inference.client import BaseLLM, Prompt, llm_async_generate, make_training_text
from ...types import BaseMetrics, RolloutResult
from .verifier import grade_answer, verify_countdown

DOMAIN = "math"


@dataclass
class MathMetrics(BaseMetrics):
    penalty: float = 0.0


@dataclass
class RewardTable:
    wrong_answer_not_finished: float = -1.0
    wrong_answer_finished: float = -0.5
    no_answer_not_finished: float = -1.0
    no_answer_finished: float = -1.0
    unparsable_not_finished: float = -1.0
    unparsable_finished: float = -1.0
    correct_answer_not_finished: float = 0.5
    correct_answer_finished: float = 1.0
    buffer_tokens: int = 0  # 0: no overlong shaping

    @classmethod
    def from_config(cls, cfg: Any) -> "RewardTable":
        """The table from ``cfg.rewards``; keys it does not know are ignored,
        as the JAX package's pydantic model ignores them."""
        rewards = cfg.get("rewards", {}) if cfg is not None else {}
        known = {f.name for f in dataclasses.fields(cls)}
        values = {k: v for k, v in (rewards.items() if hasattr(rewards, "items") else ()) if k in known}
        return cls(**{k: int(v) if k == "buffer_tokens" else float(v) for k, v in values.items()})


def get_reward(answer_status: str, finished: bool, table: RewardTable) -> float:
    key = {"wrong": "wrong_answer", "no_answer": "no_answer", "unparsable": "unparsable",
           "correct": "correct_answer"}[answer_status]
    suffix = "finished" if finished else "not_finished"
    return float(getattr(table, f"{key}_{suffix}"))


def length_penalty(max_length: int, sequence_length: int, buffer_tokens: int) -> float:
    """Linear penalty inside the last ``buffer_tokens`` of the budget, from 0
    down to -1 at ``max_length``."""
    if (max_length - buffer_tokens) < sequence_length <= max_length:
        return ((max_length - buffer_tokens) - sequence_length) / buffer_tokens
    return 0.0


def _environment_servers(cfg: Any) -> list[tuple[str, int]]:
    """(host, port) of each entry of ``cfg.environment`` that names a port."""
    env = cfg.get("environment") if hasattr(cfg, "get") else None
    if not env:
        return []
    servers = []
    for entry in env if isinstance(env, list) else [env]:
        host = entry.get("hostname", "127.0.0.1") if hasattr(entry, "get") else "127.0.0.1"
        port = entry.get("port") if hasattr(entry, "get") else None
        if port:
            servers.append((host, int(port)))
    return servers


def refuse_environment(cfg: Any, what: str = "verifier servers") -> None:
    """Raise where the JAX package would reach an environment server over
    HTTP: ``cfg.environment`` names one (an entry with a port). The
    environment servers are not ported."""
    if _environment_servers(cfg):
        raise NotImplementedError(
            f"{what} (cfg.environment) are not ported yet (ROADMAP Queue 1, item 5); "
            "drop environment to run in process"
        )


def task_messages(cfg: Any, task: str) -> list[dict]:
    """The system prompt (if any) and ``actor.task_template`` over the task."""
    actor = cfg.get("actor") if cfg is not None else None
    messages = []
    if actor is not None and actor.get("system_prompt"):
        messages.append({"role": "system", "content": actor.get("system_prompt")})
    template = actor.get("task_template", "{task}") if actor is not None else "{task}"
    messages.append({"role": "user", "content": template.format(task=task)})
    return messages


def shaped_reward(cfg: Any, llm: BaseLLM, answer_status: str, finished: bool, output_tokens: int) -> tuple[float, float]:
    """→ (reward, overlong penalty): the table's value, discounted by
    ``actor.discount_factor`` per output token, plus the overlong penalty."""
    table = RewardTable.from_config(cfg)
    actor = cfg.get("actor") if cfg is not None else None
    discount = float(actor.get("discount_factor", 1.0)) if actor is not None else 1.0
    reward = get_reward(answer_status, finished, table) * discount**output_tokens
    penalty = 0.0
    if table.buffer_tokens > 0:
        penalty = length_penalty(int(llm.parameters.get("max_tokens", 0)), output_tokens, table.buffer_tokens)
    return reward + penalty, penalty


async def generate_math_rollout(cfg: Any, llm: BaseLLM, problem: dict, session: Any = None) -> RolloutResult:
    refuse_environment(cfg)
    time_start = time.time()
    llm_call = await llm_async_generate(llm, Prompt(messages=task_messages(cfg, problem["task"])), session)
    latency = time.time() - time_start

    prediction = llm_call.output.content or ""
    loop = asyncio.get_running_loop()
    if "numbers" in problem and "target" in problem:
        answer_status = await loop.run_in_executor(
            None, verify_countdown, prediction, list(problem["numbers"]), int(problem["target"]))
    else:
        answer_status = await loop.run_in_executor(None, grade_answer, prediction, str(problem.get("answer", "")))

    trace = make_training_text(llm, llm_call)
    reward, penalty = shaped_reward(cfg, llm, answer_status, trace.finished, llm_call.output_length_tokens)
    trace.reward = reward
    metrics = MathMetrics(
        reward=reward,
        success=answer_status == "correct",
        no_error=answer_status != "unparsable",
        no_answer=answer_status == "no_answer",
        penalty=penalty,
    )
    return RolloutResult(training_texts=[trace], metrics=metrics, latency=latency,
                         dataset_name=problem.get("dataset"), domain=DOMAIN)
