"""Coding dataset loaders.

Port of the JAX package's ``domains/coding/dataset.py``: TACO/APPS-style
rows (``{"inputs", "outputs"}`` test dicts, optional ``fn_name``),
LiveCodeBench-style rows from local ``.jsonl`` files, and the hermetic
``synthetic_coding`` set, item for item. The hub sets (``taco``, ``apps``,
``livecodebench``) need dataset files that are not in the repository (and
the ``datasets`` package), so their names raise.
"""

from __future__ import annotations

import json
import random
from pathlib import Path
from typing import Any

DOMAIN = "coding"

HUB_SETS = ("taco", "apps", "livecodebench")


def _standardize(row: dict[str, Any], dataset: str) -> dict[str, Any] | None:
    task = row.get("question") or row.get("task") or row.get("question_content")
    tests = row.get("input_output") or row.get("tests") or row.get("public_test_cases")
    if isinstance(tests, str):
        try:
            tests = json.loads(tests)
        except json.JSONDecodeError:
            tests = None
    if not task or not tests:
        return None
    return {"task": str(task), "tests": tests, "dataset": dataset, "domain": DOMAIN}


def _synthetic_coding(n: int = 128, seed: int = 0) -> list[dict]:
    """Hermetic set: read two integers, print their sum."""
    rng = random.Random(seed)
    problems = []
    for _ in range(n):
        a, b = rng.randint(1, 99), rng.randint(1, 99)
        problems.append({
            "task": "Read two integers from stdin (one per line) and print their sum.",
            "tests": {"inputs": [f"{a}\n{b}", f"{b}\n{a}"], "outputs": [str(a + b), str(a + b)]},
            "dataset": "synthetic_coding",
            "domain": DOMAIN,
        })
    return problems


def load_datasets(dataset_names: list[str]) -> list[dict]:
    problems: list[dict] = []
    for name in dataset_names:
        if name == "synthetic_coding":
            problems.extend(_synthetic_coding())
        elif name in HUB_SETS:
            raise ValueError(
                f"coding dataset {name!r} is a hub dataset, which needs dataset files that are not in the "
                "repository; use synthetic_coding or a local .jsonl file"
            )
        elif Path(name).exists():
            for line in Path(name).read_text().splitlines():
                if line.strip():
                    std = _standardize(json.loads(line), Path(name).stem)
                    if std:
                        problems.append(std)
        else:
            raise ValueError(f"Unknown coding dataset {name!r}")
    return problems


load_problems = load_datasets
