"""Function-calling rollout: the tools go through the chat template
(``Prompt.tools``), and the reward is the AST match score with partial
credit, as the JAX package's ``domains/fn_calling/rollouts.py`` gives it."""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any

from ...inference.client import BaseLLM, Prompt, llm_async_generate, make_training_text
from ...types import BaseMetrics, RolloutResult
from .verifier import ast_match_score, parse_call

DOMAIN = "fn_calling"


@dataclass
class FnCallingMetrics(BaseMetrics):
    ast_score: float = 0.0
    n_calls: int = 0


async def generate_fn_calling_rollout(cfg: Any, llm: BaseLLM, problem: dict, session: Any = None) -> RolloutResult:
    start = time.time()
    actor = cfg.get("actor") if cfg is not None else None
    messages = []
    if actor is not None and actor.get("system_prompt"):
        messages.append({"role": "system", "content": actor.get("system_prompt")})
    messages.append({"role": "user", "content": str(problem.get("task") or problem.get("question"))})
    tools = problem.get("tools") or problem.get("function") or []
    if tools and not isinstance(tools, list):
        tools = [tools]
    # BFCL rows give bare function schemas: wrap them in the OpenAI tool format
    wrapped = [t if t.get("type") == "function" else {"type": "function", "function": t} for t in tools]
    llm_call = await llm_async_generate(llm, Prompt(messages=messages, tools=wrapped or None), session)
    content = llm_call.output.content or ""
    score = ast_match_score(content, problem.get("gold_calls") or problem.get("answer") or [])

    trace = make_training_text(llm, llm_call)
    trace.reward = score
    n_calls = len(parse_call(content))
    metrics = FnCallingMetrics(
        reward=score,
        success=score >= 1.0 - 1e-9,
        no_error=True,
        no_answer=n_calls == 0,
        ast_score=score,
        n_calls=n_calls,
    )
    return RolloutResult(training_texts=[trace], metrics=metrics, latency=time.time() - start,
                         dataset_name=problem.get("dataset"), domain=DOMAIN)
