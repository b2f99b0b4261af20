"""Number-guessing domain, the canonical multi-turn example.

A copy of the JAX package's ``domains/guessing.py`` (stdlib only): up to 13
turns with higher/lower feedback, reward 2 - i/10 on success at turn i and
-2 + i/10 on a format error. Each turn's prompt is the initial messages plus
one feedback message that lists the guesses so far; it leaves out the
earlier assistant replies, so a turn's prompt does not extend the previous
turn's transcript. ``load_problems`` gives the same targets as JAX's.
"""

from __future__ import annotations

import re
import time
from typing import Any

from ..inference.client import BaseLLM, Prompt, llm_async_generate, make_training_text
from ..types import BaseMetrics, RolloutResult

DOMAIN = "guessing"

_ANSWER_RE = re.compile(r"<answer>(\d+)</answer>")


async def generate_guessing_rollout(
    cfg: Any, llm: BaseLLM, problem: dict, session: Any = None
) -> RolloutResult:
    initial_messages = [
        {"role": "system", "content": "You are a helpful assistant"},
        {
            "role": "user",
            "content": (
                "You must guess a number between 1 and 1024. Output the answer as "
                "<answer>number</answer>. After each guess I will tell you if your "
                "answer is higher or lower than the target number."
            ),
        },
    ]
    time_start = time.time()
    llm_calls = []
    guess_history: list[int] = []
    reward = 0.0
    success = 0
    error = 0
    for i in range(13):
        messages = list(initial_messages)
        if i > 0:
            feedback = f"Your {i} previous guesses:"
            for guess in guess_history:
                relation = "lower" if guess < problem["answer"] else "higher"
                feedback += f"\n{guess}, which is {relation} than the target number."
            messages.append({"role": "user", "content": feedback})
        llm_call = await llm_async_generate(llm, Prompt(messages=messages), session)
        llm_calls.append(llm_call)

        output_text = llm_call.output.content or ""
        match = _ANSWER_RE.search(output_text)
        if match:
            answer = int(match.group(1))
            if answer == problem["answer"]:
                reward = 2 - i / 10
                success = 1
                break
            guess_history.append(answer)
        else:
            reward = -2 + i / 10
            error = 1
            break
    latency = time.time() - time_start

    training_texts = [make_training_text(llm, call) for call in llm_calls]
    for text in training_texts:
        text.reward = reward

    metrics = BaseMetrics(
        reward=reward, success=success, no_error=not error, no_answer=error
    )
    return RolloutResult(
        training_texts=training_texts,
        metrics=metrics,
        latency=latency,
        dataset_name=problem.get("dataset"),
        domain=DOMAIN,
    )


def load_problems(dataset_names: list[str]) -> list[dict]:
    n, c = 1024, 191
    problems = []
    for name in dataset_names:
        if name == "train":
            problems.extend(
                {"answer": (2 * i * c) % n + 1, "dataset": "train", "domain": DOMAIN}
                for i in range(512)
            )
        elif name == "test":
            problems.extend(
                {"answer": ((2 * i + 1) * c) % n + 1, "dataset": "test", "domain": DOMAIN}
                for i in range(512)
            )
        else:
            raise ValueError(f"Unknown guessing dataset {name!r}")
    return problems
