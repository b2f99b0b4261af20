"""End-to-end learning oracle on the port: the whole inline loop (engine
rollouts, groups, LOO advantages, packing, REINFORCE updates, in-flight
weight pushes paced by max_lag) teaches the tiny model of ``bandit_cpu``
the single-token bandit, through the port's CLI on the CPU. The port's
counterpart of tests/test_e2e_bandit.py."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.slow
def test_bandit_learns_on_the_port(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "pipelinerl_tpu_torch.launch", "--config-name=bandit_cpu", f"output_dir={tmp_path}",
         "finetune.save_checkpoint_steps=0", "device=cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    stats = json.loads(proc.stdout.strip().splitlines()[-1])
    assert stats["trainer"]["completed_steps"] >= 10, stats
    assert stats["trainer"]["last_broadcasted_version"] > 0
    with open(tmp_path / "streams" / "stats" / "0" / "0.jsonl") as f:
        rewards = [json.loads(line)["reward_mean"] for line in f if "reward_mean" in line]
    assert len(rewards) >= 3, rewards
    early, late = sum(rewards[:2]) / 2, sum(rewards[-2:]) / 2
    assert late > early + 0.1, f"no learning: reward {early:.3f} -> {late:.3f} ({rewards})"
