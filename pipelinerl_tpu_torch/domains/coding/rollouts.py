"""Coding rollout: generate code, run the problem's tests, grade through the
math reward table plus the overlong penalty.

Port of the JAX package's ``domains/coding/rollouts.py``. With
``sandbox_url`` set the tests run on that SandboxFusion service; with none,
``_unverifiable_executor`` refuses to run code, so a completion with code
grades ``unparsable`` (a compile error) and one without grades
``no_answer``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any

from ...inference.client import BaseLLM, Prompt, llm_async_generate, make_training_text
from ...types import BaseMetrics, RolloutResult
from ..math.rollouts import RewardTable, get_reward, length_penalty
from ..tir.sandbox import SandboxFusionClient
from .verifier import evaluate_coding_prediction

DOMAIN = "coding"

_SYSTEM_PROMPT = (
    "Solve the programming problem. Think step by step, then output the full "
    "solution as a single Python code block."
)


@dataclass
class CodingMetrics(BaseMetrics):
    penalty: float = 0.0
    compile_error: bool = False
    runtime_error: bool = False
    timeout_error: bool = False
    passed: int = 0
    total: int = 0


def _format_task(problem: dict[str, Any]) -> str:
    task = str(problem.get("task") or problem.get("question") or problem.get("problem") or "")
    tests = problem.get("tests")
    fn_name = tests.get("fn_name") if isinstance(tests, dict) else None
    if fn_name and fn_name not in task:
        task += f"\n\nYour function should be named `{fn_name}`."
    return task


async def _unverifiable_executor(code: str) -> str:
    return "[execution error: no sandbox configured — set sandbox_url]"


async def generate_coding_rollout(cfg: Any, llm: BaseLLM, problem: dict, session: Any = None) -> RolloutResult:
    start = time.time()
    actor_cfg = cfg.actor if hasattr(cfg, "actor") else cfg
    messages = [
        {"role": "system", "content": actor_cfg.get("system_prompt") or _SYSTEM_PROMPT},
        {"role": "user", "content": _format_task(problem)},
    ]
    llm_call = await llm_async_generate(llm, Prompt(messages=messages), session)

    sandbox_url = cfg.get("sandbox_url") if hasattr(cfg, "get") else None
    if sandbox_url:
        sandbox = SandboxFusionClient(sandbox_url, timeout=float(cfg.get("sandbox_timeout", 30.0)))

        async def executor(code: str) -> str:
            return await sandbox.execute(code, session)
    else:
        executor = _unverifiable_executor

    tests = problem.get("tests") or problem.get("input_output") or []
    verification = await evaluate_coding_prediction(
        llm_call.output.content or "", tests, executor,
        max_tests=int(cfg.get("max_coding_tests", 16) if hasattr(cfg, "get") else 16),
    )

    trace = make_training_text(llm, llm_call)
    table = RewardTable.from_config(cfg)
    reward = get_reward(verification.answer_status, trace.finished, table)
    overlong_penalty = 0.0
    if table.buffer_tokens > 0:
        overlong_penalty = length_penalty(int(llm.parameters.get("max_tokens", 0)), llm_call.output_length_tokens,
                                          table.buffer_tokens)
        reward += overlong_penalty
    trace.reward = reward

    metrics = CodingMetrics(
        reward=reward,
        success=verification.answer_status == "correct",
        no_error=not (verification.compile_error or verification.runtime_error),
        no_answer=verification.empty_response,
        penalty=overlong_penalty,
        compile_error=verification.compile_error,
        runtime_error=verification.runtime_error,
        timeout_error=verification.timeout_error,
        passed=verification.passed,
        total=verification.total,
    )
    return RolloutResult(training_texts=[trace], metrics=metrics, latency=time.time() - start,
                         dataset_name=problem.get("dataset"), domain=DOMAIN)
