"""Host-side helpers: per-stage logging and stats math.

Port of the parts of the JAX package's ``utils/__init__.py`` that the
inline RL loop uses.
"""

from __future__ import annotations

import logging
import sys
from pathlib import Path
from typing import Iterable

import numpy as np


def setup_logging(stage_dir: str | Path | None = None, level: int = logging.INFO) -> None:
    """stderr plus info/error log files under the stage directory."""
    handlers: list[logging.Handler] = [logging.StreamHandler(sys.stderr)]
    if stage_dir is not None:
        Path(stage_dir).mkdir(parents=True, exist_ok=True)
        for name, lvl in (("info", logging.INFO), ("error", logging.ERROR)):
            fh = logging.FileHandler(Path(stage_dir) / f"{name}.log")
            fh.setLevel(lvl)
            handlers.append(fh)
    logging.basicConfig(
        level=level, format="%(asctime)s %(levelname)s %(name)s: %(message)s", handlers=handlers, force=True
    )


def calculate_stats(values: Iterable[float]) -> dict[str, float]:
    """mean/min/max/var aggregate of the actor's metric windows."""
    arr = np.asarray(list(values), dtype=np.float64)
    if arr.size == 0:
        return {}
    return {"mean": float(arr.mean()), "min": float(arr.min()), "max": float(arr.max()), "var": float(arr.var())}


def always_or_never_success_stats(problem_success: dict[str, list[float]]) -> dict[str, float]:
    """Fraction of problems that always, sometimes or never succeed."""
    if not problem_success:
        return {}
    always = sometimes = never = 0
    for successes in problem_success.values():
        if not successes:
            continue
        if all(successes):
            always += 1
        elif any(successes):
            sometimes += 1
        else:
            never += 1
    total = max(1, always + sometimes + never)
    return {"always_success": always / total, "sometimes_success": sometimes / total, "never_success": never / total}


class SlidingWindowAggregator:
    """Windowed throughput: the rate of the last ``window_size`` updates."""

    def __init__(self, window_size: int = 50):
        self.window_size = window_size
        self._values: list[tuple[float, float]] = []  # (timestamp, value)

    def update(self, timestamp: float, value: float) -> None:
        self._values.append((timestamp, value))
        if len(self._values) > self.window_size:
            self._values = self._values[-self.window_size :]

    def rate_per_sec(self) -> float:
        if len(self._values) < 2:
            return 0.0
        t0, t1 = self._values[0][0], self._values[-1][0]
        if t1 <= t0:
            return 0.0
        return sum(v for _, v in self._values[1:]) / (t1 - t0)
