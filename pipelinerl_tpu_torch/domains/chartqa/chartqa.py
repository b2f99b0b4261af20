"""ChartQA VLM domain: single-turn questions over chart images.

Port of the JAX package's ``domains/chartqa/chartqa.py``: base64 PNG
data-URL image messages, the system prompt and task template, the 8-way
(answer status x finished) reward table, the output-length discount and
relaxed-correctness evaluation. The processor extracts the pixel features
once and they flow with the call into the ``TrainingText``. Repaired
against the JAX rollout: the preset's task template, whose literal
``\\boxed{}`` makes ``str.format`` raise there, is rendered
(``render_task``).

A problem carries its image under ``image``: a uint8 array or PNG bytes,
which become a PNG data URL (``image_to_data_url``, the port's own PNG
encoder), or the image processor's features ``{"pixel_values",
"image_grid_thw"}``, which pass as an image part; or it carries a
pre-built ``message``. The HuggingFaceM4/ChartQA hub splits are not in the
repository, so ``load_datasets`` raises on them.
"""

from __future__ import annotations

import base64
import logging
import time
from typing import Any

import numpy as np

from ...inference.client import BaseLLM, Prompt, llm_async_generate, make_training_text
from ...inference.image_pipeline import PNG_SIGNATURE, encode_png
from ...types import BaseMetrics, RolloutResult
from ..math.rollouts import RewardTable, get_reward
from .evaluation import evaluate_answer

logger = logging.getLogger(__name__)

DOMAIN = "chartqa"


def image_to_data_url(image) -> str:
    """A PNG data URL of a uint8 array ([H, W], [H, W, 3] or [H, W, 4]) or
    of PNG bytes."""
    if isinstance(image, (bytes, bytearray)):
        if bytes(image[:8]) != PNG_SIGNATURE:
            raise ValueError("image_to_data_url takes PNG bytes or a uint8 array")
        data = bytes(image)
    else:
        data = encode_png(np.asarray(image))
    return "data:image/png;base64," + base64.b64encode(data).decode()


def multimodal_message(image, question: str) -> dict:
    """The user message of one chart: its image part (a PNG data URL, as the
    JAX package builds it; the image processor's features as they are),
    then the question."""
    if isinstance(image, dict) and "pixel_values" in image:
        part = {"type": "image", "image": image}
    else:
        part = {"type": "image_url", "image_url": {"url": image_to_data_url(image)}}
    return {"role": "user", "content": [part, {"type": "text", "text": question}]}


def render_task(template: str, question: str) -> str:
    """The task template with the question in its ``{question}`` and
    ``{task}`` fields. The preset's template ends in a literal
    ``\\boxed{}``, which ``str.format`` takes for a positional field and
    raises on (as the JAX rollout does); where ``str.format`` fails, the
    named fields are replaced and every other brace stays as written."""
    try:
        return template.format(task=question, question=question)
    except (IndexError, KeyError, ValueError):
        return template.replace("{question}", question).replace("{task}", question)


def load_datasets(dataset_names: list[str]) -> list[dict]:
    """The HuggingFaceM4/ChartQA splits are hub datasets whose files are not
    in the repository, so every name raises."""
    for name in dataset_names:
        raise ValueError(
            f"chartqa dataset {name!r} is the HuggingFaceM4/ChartQA hub split, whose files are not in the "
            "repository; build problems with an image (a uint8 array or PNG bytes) and a question instead"
        )
    return []


async def generate_chartqa_rollout(cfg: Any, llm: BaseLLM, problem: dict, session: Any = None) -> RolloutResult:
    time_start = time.time()
    messages = []
    system_prompt = cfg.actor.get("system_prompt")
    if system_prompt:
        messages.append({"role": "system", "content": system_prompt})
    question = render_task(str(cfg.actor.get("task_template", "{task}")), problem["question"])
    if "message" in problem:  # a pre-built message
        messages.append(problem["message"])
    else:
        messages.append(multimodal_message(problem["image"], question))

    llm_call = await llm_async_generate(llm, Prompt(messages=messages), session)
    trace = make_training_text(llm, llm_call)
    answer_status = evaluate_answer(llm_call.output.content or "", problem["answer"])

    reward = get_reward(answer_status, trace.finished, RewardTable.from_config(cfg))
    discount = float(cfg.actor.get("discount_factor", 1.0))
    reward *= discount**llm_call.output_length_tokens
    trace.reward = reward

    metrics = BaseMetrics(
        reward=reward,
        success=answer_status == "correct",
        no_error=answer_status != "unparsable",
        no_answer=answer_status == "no_answer",
    )
    return RolloutResult(
        training_texts=[trace],
        metrics=metrics,
        latency=time.time() - time_start,
        dataset_name=problem.get("dataset"),
        domain=DOMAIN,
    )
