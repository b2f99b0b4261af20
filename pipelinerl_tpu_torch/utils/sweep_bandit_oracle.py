"""Run the bandit learning oracle over many seeds and report how often its
learning gate fails, and why.

    python -m pipelinerl_tpu_torch.utils.sweep_bandit_oracle --seeds 1-21 --jobs 3
    # on the card, the smoke's seed and kernels, one run at a time
    python -m pipelinerl_tpu_torch.utils.sweep_bandit_oracle --seeds 42 --repeats 12 --jobs 1 \
        --launcher "python3 -m pipelinerl_tpu_torch.launch engine.attn_impl=gqa finetune.attn_impl=gqa"

Each run is ``launch --config-name=bandit_tpu`` (its own 60 steps) in a
process of its own, with two OpenMP threads. Per run it prints:
- the gate that ``chip_smoke.phase_rl_loop`` applies: the mean
  ``reward_mean`` of the last two stats snapshots beats that of the first
  two by 0.1;
- whether the loop reached the target letter (a snapshot with
  ``success_mean`` of at least 0.5) and where it ended;
- the optimizer steps whose advantages were all zero (every sample of the
  step scored alike, so only the entropy bonus had a gradient), in windows
  of consecutive steps, with the summed token entropy (``rl/entropy``) at
  the first and last step of each window and the summed reward
  (``rl/reward``) of the step after it.
The last line is a JSON summary.

``--launcher`` replaces the command each run starts with (by default the
port's ``launch`` with ``device=cpu``): any launcher that takes the same overrides
and writes the same ``stats`` stream and ``metrics/trainer_0.jsonl`` is
swept the same way.
"""

from __future__ import annotations

import argparse
import json
import os
import shlex
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from ..streams import SingleStreamSpec, StreamReader

PRESET = "bandit_tpu"
THREADS = 2  # OpenMP threads of each run
GATE = 0.1  # chip_smoke.phase_rl_loop: late > early + GATE
REACHED = 0.5  # a snapshot's success_mean at or above this reached the target


def parse_seeds(text: str) -> list[int]:
    """``"1-3,42"`` -> ``[1, 2, 3, 42]``."""
    seeds = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        seeds.extend(range(int(lo), int(hi or lo) + 1))
    return seeds


def zero_advantage_windows(steps: list[dict]) -> list[dict]:
    """Windows of consecutive steps whose advantages were all zero: their
    first and last step, the summed entropy at both, and the summed reward
    of the step after the window (None when the run ended in it)."""
    windows, start = [], None
    for i, s in enumerate(steps + [None]):
        zero = s is not None and s["rl/max_advantage"] == 0 and s["rl/min_advantage"] == 0
        if zero and start is None:
            start = i
        elif not zero and start is not None:
            windows.append({"first": start, "last": i - 1, "entropy_first": steps[start]["rl/entropy"],
                            "entropy_last": steps[i - 1]["rl/entropy"],
                            "reward_after": None if s is None else s["rl/reward"]})
            start = None
    return windows


def analyse_run(out_dir: str | Path) -> dict:
    """The gate, the success curve and the zero-advantage windows of one
    finished run's output directory."""
    snaps = list(StreamReader(SingleStreamSpec(str(out_dir), "stats"), "files").read_available())
    rewards = [s["reward_mean"] for s in snaps if "reward_mean" in s]
    successes = [s["success_mean"] for s in snaps if "success_mean" in s]
    metrics = Path(out_dir) / "metrics" / "trainer_0.jsonl"
    steps = [json.loads(line) for line in metrics.read_text().splitlines()] if metrics.exists() else []
    early = sum(rewards[:2]) / 2 if len(rewards) >= 2 else None
    late = sum(rewards[-2:]) / 2 if len(rewards) >= 2 else None
    return {
        "snapshots": len(rewards),
        "early": early,
        "late": late,
        "gate": None if early is None else late > early + GATE,
        "reached": any(x >= REACHED for x in successes),
        "success_last": successes[-1] if successes else None,
        "steps": len(steps),
        "rewards": [round(r, 3) for r in rewards],
        "zero_advantage_windows": zero_advantage_windows(steps),
    }


def run_one(cmd: list[str], out_dir: Path, timeout: float) -> dict:
    out_dir.mkdir(parents=True, exist_ok=True)
    env = {**os.environ, "OMP_NUM_THREADS": str(THREADS)}
    with open(out_dir / "run.log", "w") as log:
        try:
            rc = subprocess.run(cmd, stdout=log, stderr=subprocess.STDOUT, env=env, timeout=timeout).returncode
        except subprocess.TimeoutExpired:
            rc = None
    return {"rc": rc, **analyse_run(out_dir)}


def summarise(runs: list[dict]) -> dict:
    reached = [r for r in runs if r["reached"]]
    windows = [w for r in runs for w in r["zero_advantage_windows"]]
    return {
        "runs": len(runs),
        "gate_failed": sum(r["gate"] is not True for r in runs),
        "reached_target": len(reached),
        "reached_then_left": sum((r["success_last"] or 0.0) < REACHED for r in reached),
        "zero_advantage_windows": len(windows),
        "windows_where_entropy_rose": sum(w["entropy_last"] > w["entropy_first"] for w in windows),
    }


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", default="1-21")
    ap.add_argument("--repeats", type=int, default=1, help="runs of each seed")
    ap.add_argument("--jobs", type=int, default=3, help="runs at a time")
    ap.add_argument("--timeout", type=float, default=900.0, help="seconds a run may take")
    ap.add_argument("--out", default="_archive/sweep_bandit_oracle", help="directory of the runs' outputs (git-ignored)")
    ap.add_argument("--label", default="torch", help="prefix of each run's directory")
    ap.add_argument("--launcher", default=f"{shlex.quote(sys.executable)} -m pipelinerl_tpu_torch.launch device=cpu")
    args = ap.parse_args(argv)

    jobs = []
    for seed in parse_seeds(args.seeds):
        for rep in range(args.repeats):
            out_dir = Path(args.out) / (f"{args.label}-{seed}" + (f"-{rep}" if args.repeats > 1 else ""))
            cmd = [*shlex.split(args.launcher), f"--config-name={PRESET}", f"output_dir={out_dir}",
                   "finetune.save_checkpoint_steps=0", f"seed={seed}"]
            jobs.append((seed, out_dir, cmd))
    with ThreadPoolExecutor(args.jobs) as pool:
        results = list(pool.map(lambda j: run_one(j[2], j[1], args.timeout), jobs))
    for (seed, out_dir, _), r in zip(jobs, results):
        gate = {True: "pass", False: "FAIL", None: "no snapshots"}[r["gate"]]
        windows = "; ".join(f"steps {w['first']}-{w['last']} entropy {w['entropy_first']:.3g} -> "
                            f"{w['entropy_last']:.3g}, reward after {w['reward_after']}"
                            for w in r["zero_advantage_windows"])
        print(f"{out_dir.name}: rc {r['rc']}, gate {gate} ({r['early']} -> {r['late']}), {r['steps']} steps, "
              f"reached the target: {r['reached']}, last success {r['success_last']}, rewards {r['rewards']}, "
              f"zero-advantage windows: {windows or 'none'}")
    summary = summarise(results)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
