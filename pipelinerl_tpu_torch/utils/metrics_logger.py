"""Per-stage metrics log: ``<output_dir>/metrics/<stage>.jsonl``, one JSON
object per step with a wall-clock stamp.

Port of the JAX package's ``utils/metrics_logger.py`` without its optional
W&B forwarding (wandb is not installed on the H100 host).
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any


class MetricsLogger:
    def __init__(self, output_dir: str | Path, stage: str):
        self.path = Path(output_dir) / "metrics" / f"{stage}.jsonl"
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._fh = open(self.path, "a", buffering=1)

    def log(self, metrics: dict[str, Any], step: int | None = None) -> None:
        record = {"_time": time.time(), **metrics}
        if step is not None:
            record["_step"] = step
        self._fh.write(json.dumps(record, default=float) + "\n")

    def close(self) -> None:
        self._fh.close()
