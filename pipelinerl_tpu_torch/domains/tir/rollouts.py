"""TIR rollout: a multi-turn tool-calling loop with python execution and a
final-answer tool, rewarded through the math table plus shaping.

Port of the JAX package's ``domains/tir/rollouts.py``: the
``run_python_code`` and ``MathAnswer`` tools, each turn's tool results
appended as ``role=tool`` messages, the python-use bonus and penalty
(clipped to ``max_abs``) and length shaping of ``compute_shaping``, the
overlong penalty over the mean turn length, and one TrainingText per
assistant turn (GSPO scores each as a sequence).
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass
from typing import Any

from ...inference.client import BaseLLM, Prompt, llm_async_generate, make_training_text
from ...types import BaseMetrics, RolloutResult, rollout_has_overflow
from ..math.rollouts import RewardTable, get_reward, length_penalty
from ..math.verifier import grade_answer
from .sandbox import SandboxFusionClient, safe_expression_executor
from .tool_parser import parse_tool_calls

DOMAIN = "tir"


def build_tool_definitions() -> list[dict]:
    return [
        {
            "type": "function",
            "function": {
                "name": "run_python_code",
                "description": "Execute Python code. Print only the final result.",
                "parameters": {
                    "type": "object",
                    "properties": {"code": {"type": "string", "description": "Python code to execute"}},
                    "required": ["code"],
                },
            },
        },
        {
            "type": "function",
            "function": {
                "name": "MathAnswer",
                "description": "Submit the final answer in LaTeX \\boxed{} format.",
                "parameters": {
                    "type": "object",
                    "properties": {"answer": {"type": "string", "description": "The final answer"}},
                    "required": ["answer"],
                },
            },
        },
    ]


@dataclass
class TIRMetrics(BaseMetrics):
    num_python_calls: int = 0
    num_steps: int = 0
    overflow: bool = False


def _parse_args(arguments: str, fallback_key: str | None = None) -> dict:
    try:
        parsed = json.loads(arguments)
    except (json.JSONDecodeError, TypeError):
        return {}
    if isinstance(parsed, dict):
        return parsed
    if fallback_key and isinstance(parsed, str):
        return {fallback_key: parsed}
    return {}


def compute_shaping(cfg: Any, answer_status: str, num_python_calls: int, avg_out: float, max_gen: int) -> float:
    """The python-use bonus and penalty, clipped to ``±max_abs``, plus length
    shaping against a target of ``target_ratio`` of the budget (or
    ``target_output_tokens``)."""
    total = 0.0
    pcfg = cfg.get("python_tool_shaping") if hasattr(cfg, "get") else None
    if pcfg:
        bonus = float(pcfg.get("bonus_on_correct_with_python", 0.0))
        penalty = float(pcfg.get("penalty_on_incorrect_without_python", 0.0))
        max_abs = float(pcfg.get("max_abs", 0.2))
        t = 0.0
        if answer_status == "correct" and num_python_calls >= 1:
            t += bonus
        if answer_status in ("wrong", "unparsable") and num_python_calls == 0:
            t -= penalty
        total += max(-max_abs, min(max_abs, t))
    lcfg = cfg.get("length_shaping") if hasattr(cfg, "get") else None
    if lcfg:
        if "target_ratio" in lcfg:
            target = int(max(1, float(lcfg["target_ratio"]) * max_gen))
            target = max(int(lcfg.get("min_target_tokens", 0)), target)
            target = min(int(lcfg.get("max_target_tokens", 10**9)), target)
        else:
            target = int(lcfg.get("target_output_tokens", 512))
        slope = float(lcfg.get("slope", 0.0))
        max_pen = float(lcfg.get("max_penalty", 0.0))
        bonus_short = float(lcfg.get("bonus_on_short_correct", 0.0))
        if slope > 0 and max_pen > 0 and avg_out > target:
            total -= min(max_pen, slope * (avg_out - target))
        if bonus_short > 0 and answer_status == "correct" and avg_out <= target:
            total += bonus_short
    return total


async def generate_tir_rollout(cfg: Any, llm: BaseLLM, problem: dict, session: Any = None) -> RolloutResult:
    start = time.perf_counter()
    actor_cfg = cfg.actor if hasattr(cfg, "actor") else cfg
    system_prompt = actor_cfg.get(
        "system_prompt",
        "Solve the problem step by step. You may call run_python_code to "
        "compute, and you MUST submit your final answer with the MathAnswer tool.",
    )
    messages: list[dict] = []
    if system_prompt:
        messages.append({"role": "system", "content": system_prompt})
    task_template = actor_cfg.get("task_template", "{task}")
    messages.append({"role": "user", "content": task_template.format(task=problem["task"])})
    tools = build_tool_definitions()

    sandbox_url = cfg.get("sandbox_url") if hasattr(cfg, "get") else None
    if sandbox_url:
        sandbox = SandboxFusionClient(sandbox_url, timeout=float(cfg.get("sandbox_timeout", 30.0)))

        async def execute(code: str) -> str:
            return await sandbox.execute(code, session)
    else:
        execute = safe_expression_executor

    max_turns = int(actor_cfg.get("max_turns", 6))
    llm_calls = []
    final_answer: str | None = None
    num_python_calls = 0

    for _turn in range(max_turns):
        llm_call = await llm_async_generate(llm, Prompt(messages=list(messages), tools=tools), session)
        llm_calls.append(llm_call)
        content = llm_call.output.content or ""
        tool_calls, clean_content = parse_tool_calls(content)
        messages.append({"role": "assistant", "content": content})
        if not tool_calls:
            # no tool call: the content is the final response
            final_answer = clean_content or content
            break
        stop = False
        for tc in tool_calls:
            if tc.function.name == "MathAnswer":
                args = _parse_args(tc.function.arguments, "answer")
                final_answer = str(args.get("answer", ""))
                messages.append({"role": "tool", "tool_call_id": tc.id, "content": f"Answer submitted: {final_answer}"})
                stop = True
            elif tc.function.name == "run_python_code":
                args = _parse_args(tc.function.arguments, "code")
                code = args.get("code") or args.get("python_code", "")
                result = await execute(code)
                num_python_calls += 1
                messages.append({"role": "tool", "tool_call_id": tc.id, "content": str(result)})
            else:
                messages.append({"role": "tool", "tool_call_id": tc.id, "content": f"Unknown tool: {tc.function.name}"})
        if stop:
            break

    gold = str(problem.get("answer", ""))
    if final_answer is None:
        answer_status = "no_answer"
    else:
        pred = final_answer if "\\boxed" in final_answer else f"\\boxed{{{final_answer}}}"
        answer_status = grade_answer(pred, gold)

    traces = [make_training_text(llm, call) for call in llm_calls]
    finished = not rollout_has_overflow(traces)
    table = RewardTable.from_config(cfg)
    reward = get_reward(answer_status, finished, table)
    max_gen = int(llm.parameters.get("max_tokens", 2048))
    avg_out = sum(c.output_length_tokens for c in llm_calls) / max(1, len(llm_calls))
    reward += compute_shaping(cfg, answer_status, num_python_calls, avg_out, max_gen)
    if table.buffer_tokens > 0:
        reward += length_penalty(max_gen, int(avg_out), table.buffer_tokens)
    for t in traces:
        t.reward = reward

    metrics = TIRMetrics(
        reward=reward,
        success=answer_status == "correct",
        no_error=answer_status != "unparsable",
        no_answer=answer_status == "no_answer",
        num_python_calls=num_python_calls,
        num_steps=len(llm_calls),
        overflow=not finished,
    )
    return RolloutResult(training_texts=traces, metrics=metrics, latency=time.perf_counter() - start,
                         dataset_name=problem.get("dataset"), domain=DOMAIN)
