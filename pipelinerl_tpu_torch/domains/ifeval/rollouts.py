"""IFEval rollout: the reward is the fraction of instructions followed
(partial credit, strict checkers), as the JAX package's
``domains/ifeval/rollouts.py`` gives it. The prompt is the task alone."""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any

from ...inference.client import BaseLLM, Prompt, llm_async_generate, make_training_text
from ...types import BaseMetrics, RolloutResult
from .checkers import check_instruction

DOMAIN = "ifeval"


@dataclass
class IFEvalMetrics(BaseMetrics):
    instructions_followed: int = 0
    instructions_total: int = 0


async def generate_ifeval_rollout(cfg: Any, llm: BaseLLM, problem: dict, session: Any = None) -> RolloutResult:
    start = time.time()
    messages = [{"role": "user", "content": str(problem["task"])}]
    llm_call = await llm_async_generate(llm, Prompt(messages=messages), session)
    response = llm_call.output.content or ""

    instruction_ids = list(problem.get("instruction_id_list", []))
    kwargs_list = list(problem.get("kwargs", [])) or [{}] * len(instruction_ids)
    followed = 0
    for iid, kw in zip(instruction_ids, kwargs_list):
        try:
            followed += check_instruction(response, iid, kw)
        except KeyError:
            pass  # an unknown instruction type: no credit, no crash
    reward = followed / max(1, len(instruction_ids))

    trace = make_training_text(llm, llm_call)
    trace.reward = reward
    metrics = IFEvalMetrics(
        reward=reward,
        success=followed == len(instruction_ids),
        no_error=True,
        no_answer=not response,
        instructions_followed=followed,
        instructions_total=len(instruction_ids),
    )
    return RolloutResult(training_texts=[trace], metrics=metrics, latency=time.time() - start,
                         dataset_name=problem.get("dataset"), domain=DOMAIN)
