"""Math dataset loaders: the hermetic synthetic sets and local files.

Port of the JAX package's ``domains/math/load_datasets.py``: the synthetic
sets ``synthetic_arithmetic*`` and ``countdown``, and custom ``.json`` /
``.jsonl`` files (a plain path, or a name under ``datasets/custom`` or
``datasets/custom_runs``), with the same ids, order and ``seed`` shuffle.
Problems are dicts with ``task`` (the question), ``answer`` (gold, usually
``\\boxed{...}``), ``dataset``, ``id`` and ``domain``.

The JAX package's registry names (ORZ, MATH, AIME, ...), ``org/name`` hub
paths and ``.parquet`` files need dataset files that are not in the
repository (and the ``datasets`` package), so the port raises a
``ValueError`` for them.
"""

from __future__ import annotations

import json
import logging
import random
from pathlib import Path
from typing import Any

logger = logging.getLogger(__name__)

DOMAIN = "math"

Row = dict[str, Any]

# the JAX package's registry names, each a hub or raw-url dataset
_REGISTRY_NAMES = frozenset(
    [
        "eurus_train", "eurus_validation", "math_train", "math_test", "math_simplerl_train",
        "deepscaler_preview", "nemotron_cascade_math", "omni_math_500", "math_500", "open_r1_math_220k",
        "gpqa_main", "gpqa_diamond", "gsm8k_train", "gsm8k_test", "limo", "open_reasoner_zero_57k",
        "open_reasoner_zero_extended_72k", "open_reasoner_zero_hard_13k", "aime_2025", "aime_2025_original",
    ]
    + [f"aime_{y}{s}" for y in (2022, 2023, 2024) for s in ("", "_original")]
    + [f"amc_{y}{s}" for y in (2022, 2023) for s in ("", "_original")]
)


def _no_files(name: str, what: str) -> ValueError:
    return ValueError(
        f"math dataset {name!r} is {what}, which needs dataset files that are not in the repository; "
        "use synthetic_arithmetic, countdown or a local .json/.jsonl file"
    )


def _boxed(answer: Any) -> str:
    text = str(answer)
    return text if text.startswith("\\boxed{") else "\\boxed{" + text + "}"


def normalize_math(row: Row) -> Row | None:
    """MATH-style rows: problem/question + answer/solution."""
    verify = row.get("correctness_math_verify")
    if verify is not None and not any(verify):
        return None
    task = row.get("problem") or row.get("question")
    if not task:
        return None
    if "answer" in row and row["answer"] is not None:
        answer = _boxed(row["answer"])
    elif row.get("solution"):
        answer = row["solution"]
    else:
        return None
    out = {"task": task, "answer": answer}
    level = row.get("level")
    typ = row.get("type") or row.get("subject")
    if level:
        out["level"] = level
    if typ:
        out["type"] = typ
    return out


def _is_hf_dataset_path(name: str) -> bool:
    """``org/name``: exactly one slash, no json extension."""
    if name.count("/") != 1 or name.endswith((".jsonl", ".json")):
        return False
    org, ds = name.split("/")
    return bool(org) and bool(ds)


def _load_file(path: Path, dataset_name: str | None = None) -> list[Row]:
    if path.suffix == ".jsonl":
        rows = [json.loads(line) for line in path.read_text().splitlines() if line.strip()]
    elif path.suffix == ".json":
        rows = json.loads(path.read_text())
    elif path.suffix == ".parquet":
        raise _no_files(str(path), "a parquet file (read through the datasets package)")
    else:
        raise ValueError(f"Unsupported dataset file {path}")
    name = dataset_name or path.stem
    out = []
    for row in rows:
        if "task" in row and "answer" in row:  # already standardized
            std = dict(row)
        else:
            std = normalize_math(row)
            if std is None:
                continue
        std.setdefault("dataset", name)
        std["domain"] = DOMAIN
        out.append(std)
    return out


def _resolve_custom(name: str) -> Path | None:
    """A plain path, or ``datasets/custom{,_runs}/<name>[.jsonl]``."""
    names = [name] if name.endswith((".jsonl", ".json", ".parquet")) else [name, f"{name}.jsonl"]
    for n in names:
        for candidate in (Path(n), Path("datasets/custom") / n, Path("datasets/custom_runs") / n):
            if candidate.exists() and candidate.is_file():
                return candidate
    return None


def _synthetic_arithmetic(n: int = 512, seed: int = 0, name: str = "synthetic_arithmetic") -> list[Row]:
    rng = random.Random(seed)
    problems = []
    for _ in range(n):
        a, b = rng.randint(10, 999), rng.randint(10, 999)
        op = rng.choice(["+", "-", "*"])
        answer = {"+": a + b, "-": a - b, "*": a * b}[op]
        problems.append(
            {"task": f"What is {a} {op} {b}?", "answer": f"\\boxed{{{answer}}}", "dataset": name, "domain": DOMAIN}
        )
    return problems


def _synthetic_countdown(n: int = 256, seed: int = 0) -> list[Row]:
    rng = random.Random(seed)
    problems = []
    for _ in range(n):
        nums = [rng.randint(2, 30) for _ in range(4)]
        a, b, c, d = nums
        target = a * b + c - d
        problems.append(
            {
                "task": (
                    f"Using the numbers {nums} exactly once each with + - * / and "
                    "parentheses, write an expression equal to "
                    f"{target}. Output it as <answer>expression</answer>."
                ),
                "numbers": nums,
                "target": target,
                "answer": str(target),
                "dataset": "countdown",
                "domain": DOMAIN,
            }
        )
    return problems


def load_datasets(dataset_names: list[str] | str | None, seed: int | None = None) -> list[Row]:
    """Load and concatenate named datasets (de-duplicated, in order),
    numbering each dataset's problems from 0; ``seed`` shuffles the whole."""
    if dataset_names is None:
        return []
    if isinstance(dataset_names, str):
        dataset_names = [dataset_names]
    problems: list[Row] = []
    for name in dict.fromkeys(dataset_names):
        if name.startswith("synthetic_arithmetic"):
            samples = _synthetic_arithmetic(name=name)
        elif name == "countdown":
            samples = _synthetic_countdown()
        elif name in _REGISTRY_NAMES:
            raise _no_files(name, "a hub dataset of the JAX package's registry")
        elif (custom := _resolve_custom(name)) is not None:
            samples = _load_file(custom, dataset_name=Path(name).stem)
        elif _is_hf_dataset_path(name):
            raise _no_files(name, "a hub dataset path")
        else:
            raise ValueError(f"Unknown math dataset {name!r} (not a registry name, org/name hub path, or local file)")
        for i, sample in enumerate(samples):
            sample.setdefault("id", i)
        problems.extend(samples)
        logger.info("Loaded %s -> %d problems total", name, len(problems))
    if seed is not None:
        random.Random(seed).shuffle(problems)
    return problems


load_problems = load_datasets
