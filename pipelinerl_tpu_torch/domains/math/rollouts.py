"""Math rollout generation with the 8-way reward table and length shaping.

Port of the JAX package's ``domains/math/rollouts.py``: the (answer_status
x finished) reward table, a discount by output length, and the overlong
penalty inside the last ``buffer_tokens`` of the budget. Verification runs
over RPC on a verifier server (``verifier_api.py``) when ``cfg.environment``
names servers (over the actor's session), and in process otherwise.
"""

from __future__ import annotations

import asyncio
import dataclasses
import random
import time
from dataclasses import dataclass
from typing import Any

from ...inference.client import BaseLLM, Prompt, llm_async_generate, make_training_text
from ...types import BaseMetrics, RolloutResult
from ..servers import rollout_servers
from .verifier import grade_answer, verify_countdown
from .verifier_api import verify_answer_rpc

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


async def _verify(cfg: Any, session: Any, prediction: str, problem: dict) -> str:
    """The answer status: over RPC on a random verifier server when
    ``cfg.environment`` names servers, else in process (the same functions
    either way)."""
    extra = None
    if "numbers" in problem and "target" in problem:
        extra = {"numbers": problem["numbers"], "target": problem["target"]}
    servers = rollout_servers(cfg, session)
    if servers:
        host, port = random.choice(servers)
        return await verify_answer_rpc(session, host, port, prediction, str(problem.get("answer", "")), extra=extra)
    loop = asyncio.get_running_loop()
    if extra is not None:
        return await loop.run_in_executor(None, verify_countdown, prediction, list(problem["numbers"]),
                                          int(problem["target"]))
    return await loop.run_in_executor(None, grade_answer, prediction, str(problem.get("answer", "")))


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
    time_start = time.time()
    llm_call = await llm_async_generate(llm, Prompt(messages=task_messages(cfg, problem["task"])), session)
    latency = time.time() - time_start

    answer_status = await _verify(cfg, session, llm_call.output.content or "", problem)

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
