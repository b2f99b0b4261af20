"""Single-token bandit domain, the end-to-end learning oracle.

Port of the JAX package's ``domains/bandit.py``: reward 2.0 when the first
generated character is the problem's target letter, otherwise a dense
shaping term from the distance of the first character to the target, so
leave-one-out groups carry signal from the first step. A small model from
random weights learns it within a few dozen optimizer steps, which drives
the whole loop: rollouts, groups, advantages, packing, train steps,
in-flight weight pushes.
"""

from __future__ import annotations

import time
from typing import Any

from ..inference.client import BaseLLM, Prompt, llm_async_generate, make_training_text
from ..types import BaseMetrics, RolloutResult

DOMAIN = "bandit"


async def generate_bandit_rollout(cfg: Any, llm: BaseLLM, problem: dict, session: Any = None) -> RolloutResult:
    time_start = time.time()
    llm_call = await llm_async_generate(llm, Prompt(messages=[{"role": "user", "content": problem["prompt"]}]), session)
    content = llm_call.output.content or ""
    lstripped = content.lstrip()
    success = int(lstripped.startswith(problem["target"]))
    # shaped on decoded text, so any tokenizer works
    reward = max(0.0, 1.0 - abs(ord(lstripped[0]) - ord(problem["target"][0])) / 256.0) if lstripped else 0.0
    if success:
        reward = 2.0
    text = make_training_text(llm, llm_call)
    text.reward = reward
    return RolloutResult(
        training_texts=[text],
        metrics=BaseMetrics(reward=reward, success=success, no_error=True, no_answer=not content),
        latency=time.time() - time_start,
        dataset_name=problem.get("dataset"),
        domain=DOMAIN,
    )


def load_problems(dataset_names: list[str]) -> list[dict]:
    return [
        {"prompt": "say x", "target": "x", "dataset": name, "domain": DOMAIN}
        for name in dataset_names
        for _ in range(64)
    ]
