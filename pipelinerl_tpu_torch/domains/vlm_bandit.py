"""Visual bandit — the hermetic end-to-end learning oracle for the VLM path.

Each problem shows an "image" whose pixels are constant +c or −c; the model
must emit a LOW first byte (< 128) for + images and a HIGH one (≥ 128) for −
images. A frozen random vision tower maps the two pixel classes to distinct
visual tokens; the language trunk has to LEARN the mapping — an image-blind
policy caps at 0.5 mean success, so a higher success curve proves pixels
actually flow through engine prefill and the trainer's spliced forward.
Port of the JAX package's ``domains/vlm_bandit.py``.
"""

from __future__ import annotations

import time
from typing import Any

import numpy as np

from ..inference.client import BaseLLM, Prompt, llm_async_generate, make_training_text
from ..types import BaseMetrics, RolloutResult

DOMAIN = "vlm_bandit"

# toy image geometry: one 4x4-patch frame, merge 2 → 4 merged visual tokens
GRID = (1, 4, 4)


def make_image(sign: int, patch_dim: int, seed: int = 0) -> dict:
    n_patches = int(np.prod(GRID))
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(n_patches, patch_dim)).astype(np.float32) * 0.05
    return {
        "pixel_values": base + float(sign),
        "image_grid_thw": GRID,
    }


async def generate_vlm_bandit_rollout(
    cfg: Any, llm: BaseLLM, problem: dict, session: Any = None
) -> RolloutResult:
    time_start = time.time()
    patch_dim = int(problem.get("patch_dim", 12))
    image = make_image(problem["sign"], patch_dim)
    messages = [
        {
            "role": "user",
            "content": [
                {"type": "image", "image": image},
                {"type": "text", "text": "press"},
            ],
        }
    ]
    llm_call = await llm_async_generate(llm, Prompt(messages=messages), session)
    content = llm_call.output.content or ""
    # range-based oracle: class + wants a LOW first byte (< 128), class −
    # a HIGH one (≥ 128). A random policy is right half the time on each
    # class, so LOO groups carry dense signal from step 1, yet no
    # image-blind policy can beat 0.5 mean success — the success curve
    # directly measures image-conditional behavior.
    success = 0
    # non-byte first token (specials ≥ 256): negative reward so a group with
    # any valid sibling carries gradient AWAY from the invalid region — an
    # all-zero-reward collapse would be dropped by zero-advantage filtering
    # and leave the policy stuck with no learning signal
    reward = -0.5
    if llm_call.output_token_ids and llm_call.output_token_ids[0] < 256:
        first = llm_call.output_token_ids[0]
        lo = problem["sign"] > 0
        success = int(first < 128 if lo else first >= 128)
        center = 32 if lo else 224
        reward = float(success) + 0.25 * (1.0 - abs(first - center) / 256.0)
    text = make_training_text(llm, llm_call)
    text.reward = reward
    metrics = BaseMetrics(
        reward=reward, success=success, no_error=True, no_answer=not content
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
        for i in range(64):
            sign = 1 if i % 2 == 0 else -1
            target = "low" if sign > 0 else "high"
            problems.append(
                {
                    "sign": sign,
                    "target": target,
                    # per-class dataset tag → per-class stat aggregates
                    "dataset": f"{name}-{target}",
                    "domain": DOMAIN,
                }
            )
    return problems
