"""Gather every .json file under a folder into ``<folder>/all/tapes.json``.

Port of the JAX package's ``gather_jsons.py``::

    python -m pipelinerl_tpu_torch.gather_jsons <folder>
"""

from __future__ import annotations

import json
import sys
from pathlib import Path


def gather_jsons(folder: str | Path) -> Path:
    folder = Path(folder)
    # a previous run's output under all/ is skipped
    all_jsons = [json.loads(p.read_text()) for p in sorted(folder.rglob("*.json")) if p.parent.name != "all"]
    dst = folder / "all" / "tapes.json"
    dst.parent.mkdir(parents=True, exist_ok=True)
    with open(dst, "w") as f:
        json.dump(all_jsons, f, indent=4)
    return dst


if __name__ == "__main__":
    gather_jsons(sys.argv[1])
