"""Letter-counting domain, a single-turn verifiable task.

A copy of the JAX package's ``domains/counting.py`` (stdlib only): reward 1
when ``<answer>n</answer>`` gives the letter's count in the word, else 0;
``load_problems`` builds the same 256 problems per dataset from a seeded
``random.Random``.
"""

from __future__ import annotations

import random
import re
import time
from typing import Any

from ..inference.client import BaseLLM, Prompt, llm_async_generate, make_training_text
from ..types import BaseMetrics, RolloutResult

DOMAIN = "counting"

_ANSWER_RE = re.compile(r"<answer>(\d+)</answer>")

_WORDS = [
    "strawberry", "banana", "mississippi", "bookkeeper", "balloon", "committee",
    "tennessee", "cappuccino", "bubble", "coffee", "pepper", "letter", "parallel",
    "assessment", "possession", "millennium", "aggressive", "occurrence",
]


async def generate_counting_rollout(
    cfg: Any, llm: BaseLLM, problem: dict, session: Any = None
) -> RolloutResult:
    time_start = time.time()
    messages = [
        {"role": "system", "content": "You are a helpful assistant"},
        {
            "role": "user",
            "content": (
                f"How many times does the letter '{problem['letter']}' appear in the "
                f"word '{problem['word']}'? Output the answer as <answer>count</answer>."
            ),
        },
    ]
    llm_call = await llm_async_generate(llm, Prompt(messages=messages), session)
    output_text = llm_call.output.content or ""
    match = _ANSWER_RE.search(output_text)
    success = 0
    no_answer = 1
    if match:
        no_answer = 0
        success = int(int(match.group(1)) == problem["count"])
    reward = float(success)

    text = make_training_text(llm, llm_call)
    text.reward = reward
    metrics = BaseMetrics(
        reward=reward, success=success, no_error=not no_answer, no_answer=no_answer
    )
    return RolloutResult(
        training_texts=[text],
        metrics=metrics,
        latency=time.time() - time_start,
        dataset_name=problem.get("dataset"),
        domain=DOMAIN,
    )


def load_problems(dataset_names: list[str]) -> list[dict]:
    problems = []
    for name in dataset_names:
        rng = random.Random(0 if name == "train" else 1)
        for _ in range(256):
            word = rng.choice(_WORDS)
            letter = rng.choice(sorted(set(word)))
            problems.append(
                {
                    "word": word,
                    "letter": letter,
                    "count": word.count(letter),
                    "dataset": name,
                    "domain": DOMAIN,
                }
            )
    return problems
