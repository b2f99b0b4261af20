"""Logic rollout generation.

Port of the JAX package's ``domains/logic/rollouts.py``: the prompt from
``actor.system_prompt`` and ``actor.task_template``, the answer status from
the in-process ``verify_answer``, and the math domain's reward table with its
discount and overlong penalty. A config that names verifier servers raises,
as the math domain's does (ROADMAP Queue 1 item 5).
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass
from typing import Any

from ...inference.client import BaseLLM, Prompt, llm_async_generate, make_training_text
from ...types import BaseMetrics, RolloutResult
from ..math.rollouts import refuse_environment, shaped_reward, task_messages
from .verifiers import verify_answer

DOMAIN = "logic"


@dataclass
class LogicMetrics(BaseMetrics):
    penalty: float = 0.0


async def generate_logic_rollout(cfg: Any, llm: BaseLLM, problem: dict, session: Any = None) -> RolloutResult:
    refuse_environment(cfg)
    time_start = time.time()
    llm_call = await llm_async_generate(llm, Prompt(messages=task_messages(cfg, problem["task"])), session)
    latency = time.time() - time_start

    answer_status = await asyncio.get_running_loop().run_in_executor(
        None, verify_answer, llm_call.output.content or "", problem.get("reward_context") or {})

    trace = make_training_text(llm, llm_call)
    reward, penalty = shaped_reward(cfg, llm, answer_status, trace.finished, llm_call.output_length_tokens)
    trace.reward = reward
    metrics = LogicMetrics(
        reward=reward,
        success=answer_status == "correct",
        no_error=answer_status != "unparsable",
        no_answer=answer_status == "no_answer",
        penalty=penalty,
    )
    return RolloutResult(training_texts=[trace], metrics=metrics, latency=latency,
                         dataset_name=problem.get("dataset"), domain=DOMAIN)
