"""Function-calling dataset loaders (BFCL v3-style rows: question + function
schemas + gold call answers): local jsonl and the hermetic synthetic set,
as the JAX package's ``domains/fn_calling/dataset.py`` loads them."""

from __future__ import annotations

import json
import logging
import random
from pathlib import Path
from typing import Any

logger = logging.getLogger(__name__)

DOMAIN = "fn_calling"


def _standardize(row: dict[str, Any], dataset: str) -> dict[str, Any] | None:
    question = row.get("question") or row.get("task")
    if isinstance(question, list):  # BFCL multi-turn format: first user turn
        flat = question[0] if question and isinstance(question[0], list) else question
        question = next(
            (m.get("content") for m in flat if isinstance(m, dict) and m.get("role") == "user"),
            None,
        )
    tools = row.get("function") or row.get("tools")
    gold = row.get("answer") or row.get("ground_truth") or row.get("gold_calls")
    if isinstance(gold, str):
        try:
            gold = json.loads(gold)
        except json.JSONDecodeError:
            return None
    if not question or gold is None:
        return None
    return {
        "task": str(question),
        "tools": tools if isinstance(tools, list) else ([tools] if tools else []),
        "gold_calls": gold,
        "dataset": dataset,
        "domain": DOMAIN,
    }


_WEATHER_TOOL = {
    "name": "get_weather",
    "description": "Get the current weather for a city.",
    "parameters": {
        "type": "object",
        "properties": {
            "city": {"type": "string"},
            "unit": {"type": "string", "enum": ["celsius", "fahrenheit"]},
        },
        "required": ["city"],
    },
}


def _synthetic_fn_calling(n: int = 128, seed: int = 0) -> list[dict]:
    rng = random.Random(seed)
    cities = ["Paris", "Tokyo", "Oslo", "Lima", "Cairo", "Sydney"]
    problems = []
    for _ in range(n):
        city = rng.choice(cities)
        problems.append(
            {
                "task": f"What's the weather in {city} right now?",
                "tools": [_WEATHER_TOOL],
                "gold_calls": [
                    {"name": "get_weather", "arguments": {"city": city, "unit": []}}
                ],
                "dataset": "synthetic_fn_calling",
                "domain": DOMAIN,
            }
        )
    return problems


def load_datasets(dataset_names: list[str]) -> list[dict]:
    problems: list[dict] = []
    for name in dataset_names:
        if name == "synthetic_fn_calling":
            problems.extend(_synthetic_fn_calling())
        elif Path(name).exists():
            for line in Path(name).read_text().splitlines():
                if not line.strip():
                    continue
                std = _standardize(json.loads(line), Path(name).stem)
                if std:
                    problems.append(std)
        else:
            raise ValueError(f"Unknown fn_calling dataset {name!r}")
        logger.info("Loaded %s → %d problems total", name, len(problems))
    return problems


load_problems = load_datasets
