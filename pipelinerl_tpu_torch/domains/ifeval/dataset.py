"""IFEval dataset loaders: local jsonl in the google/IFEval format
({prompt, instruction_id_list, kwargs}) and the hermetic synthetic set.

A copy of the JAX package's ``domains/ifeval/dataset.py``; the hub set
``ifeval`` needs dataset files that are not in the repository, so asking
for it raises."""

from __future__ import annotations

import json
import logging
import random
from pathlib import Path
from typing import Any

logger = logging.getLogger(__name__)

DOMAIN = "ifeval"


def _standardize(row: dict[str, Any], dataset: str) -> dict[str, Any] | None:
    task = row.get("prompt") or row.get("task")
    ids = row.get("instruction_id_list")
    if not task or not ids:
        return None
    return {
        "task": str(task),
        "instruction_id_list": list(ids),
        "kwargs": row.get("kwargs") or [{}] * len(ids),
        "dataset": dataset,
        "domain": DOMAIN,
    }


def _synthetic_ifeval(n: int = 128, seed: int = 0) -> list[dict]:
    rng = random.Random(seed)
    templates = [
        (
            "Describe your favorite season in all lowercase letters.",
            ["change_case:english_lowercase"],
            [{}],
        ),
        (
            "Write about the ocean without using any commas.",
            ["punctuation:no_comma"],
            [{}],
        ),
        (
            "List three fruits as exactly 3 bullet points using '-'.",
            ["detectable_format:number_bullet_lists"],
            [{"num_bullets": 3}],
        ),
        (
            'Answer in JSON with a "name" field.',
            ["detectable_format:json_format"],
            [{}],
        ),
        (
            "Write at least 30 words about rivers and include the word 'water'.",
            ["length_constraints:number_words", "keywords:existence"],
            [{"num_words": 30, "relation": "at least"}, {"keywords": ["water"]}],
        ),
    ]
    problems = []
    for _ in range(n):
        task, ids, kwargs = rng.choice(templates)
        problems.append(
            {
                "task": task,
                "instruction_id_list": list(ids),
                "kwargs": [dict(k) for k in kwargs],
                "dataset": "synthetic_ifeval",
                "domain": DOMAIN,
            }
        )
    return problems


def load_datasets(dataset_names: list[str]) -> list[dict]:
    problems: list[dict] = []
    for name in dataset_names:
        if name == "synthetic_ifeval":
            problems.extend(_synthetic_ifeval())
        elif name == "ifeval":
            raise ValueError(
                "ifeval dataset 'ifeval' is google/IFEval from the hub, which needs dataset files that are not in "
                "the repository; use 'synthetic_ifeval' or a local jsonl file"
            )
        elif Path(name).exists():
            for line in Path(name).read_text().splitlines():
                if not line.strip():
                    continue
                std = _standardize(json.loads(line), Path(name).stem)
                if std:
                    problems.append(std)
        else:
            raise ValueError(f"Unknown ifeval dataset {name!r}")
        logger.info("Loaded %s → %d problems total", name, len(problems))
    return problems


load_problems = load_datasets
