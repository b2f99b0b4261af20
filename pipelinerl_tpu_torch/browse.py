"""Stream browser: inspect an experiment's streams from the terminal.

Port of the JAX package's ``browse.py`` over the port's own streams (any
backend: files, binary, a stream hub's ``.scf`` mirror)::

    python -m pipelinerl_tpu_torch.browse <exp_dir>                  # list topics
    python -m pipelinerl_tpu_torch.browse <exp_dir> actor            # dump messages
    python -m pipelinerl_tpu_torch.browse <exp_dir> actor -n 5       # last 5
    python -m pipelinerl_tpu_torch.browse <exp_dir> actor --stats    # field summary
"""

from __future__ import annotations

import argparse
import json
from collections import Counter
from pathlib import Path


def _find_topics(exp_dir: Path) -> list[str]:
    """Stream files live at streams/<topic>/<instance>/<partition>.{jsonl,scf}
    (``streams.stream_file_path``); topics print as topic/instance/partition."""
    streams_dir = exp_dir / "streams"
    if not streams_dir.is_dir():
        return []
    return sorted({str(p.relative_to(streams_dir).parent / p.stem) for p in streams_dir.rglob("*")
                   if p.suffix in (".jsonl", ".scf")})


def _iter_messages(exp_dir: Path, topic: str):
    from .streams import SingleStreamSpec, StreamReader, stream_file_path

    parts = topic.split("/")
    instance = int(parts[1]) if len(parts) > 1 else 0
    partition = int(parts[2]) if len(parts) > 2 else 0
    spec = SingleStreamSpec(str(exp_dir), parts[0], instance, partition)
    backend = "binary" if stream_file_path(spec, "binary").exists() else "files"
    yield from StreamReader(spec, backend=backend).read_available()


def _summarize(messages: list[dict]) -> dict:
    fields: Counter = Counter()
    numeric: dict[str, list[float]] = {}
    for m in messages:
        if not isinstance(m, dict):
            continue
        for k, value in m.items():
            fields[k] += 1
            if isinstance(value, (int, float)) and not isinstance(value, bool):
                numeric.setdefault(k, []).append(float(value))
    return {"messages": len(messages), "fields": dict(fields),
            "numeric": {k: {"mean": sum(vs) / len(vs), "min": min(vs), "max": max(vs)} for k, vs in numeric.items()}}


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("exp_dir", type=Path)
    ap.add_argument("topic", nargs="?", help="stream topic (omit to list)")
    ap.add_argument("-n", type=int, default=0, help="show only the last N messages")
    ap.add_argument("--stats", action="store_true", help="field summary instead of dump")
    args = ap.parse_args(argv)

    if not args.topic:
        for t in _find_topics(args.exp_dir):
            print(t)
        return
    messages = list(_iter_messages(args.exp_dir, args.topic))
    if args.stats:
        print(json.dumps(_summarize(messages), indent=2, default=str))
        return
    if args.n:
        messages = messages[-args.n :]
    for m in messages:
        print(json.dumps(m, default=str))


if __name__ == "__main__":
    main()
