"""Logic rollout generation.

Port of the JAX package's ``domains/logic/rollouts.py``: the prompt from
``actor.system_prompt`` and ``actor.task_template``, the answer status from
``verify_answer`` (over RPC on a ``LogicEnvironment`` server when
``cfg.environment`` names servers, in process otherwise), and the math domain's reward table with its discount and
overlong penalty.
"""

from __future__ import annotations

import asyncio
import random
import time
from dataclasses import dataclass
from typing import Any

from ...inference.client import BaseLLM, Prompt, llm_async_generate, make_training_text
from ...types import BaseMetrics, RolloutResult
from ..math.rollouts import shaped_reward, task_messages
from ..servers import rollout_servers
from .verifier_api import verify_answer_rpc
from .verifiers import verify_answer

DOMAIN = "logic"


@dataclass
class LogicMetrics(BaseMetrics):
    penalty: float = 0.0


async def generate_logic_rollout(cfg: Any, llm: BaseLLM, problem: dict, session: Any = None) -> RolloutResult:
    time_start = time.time()
    llm_call = await llm_async_generate(llm, Prompt(messages=task_messages(cfg, problem["task"])), session)
    latency = time.time() - time_start

    prediction = llm_call.output.content or ""
    reward_context = problem.get("reward_context") or {}
    servers = rollout_servers(cfg, session)
    if servers:
        host, port = random.choice(servers)
        answer_status = await verify_answer_rpc(session, host, port, prediction, reward_context)
    else:
        answer_status = await asyncio.get_running_loop().run_in_executor(None, verify_answer, prediction,
                                                                         reward_context)

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
