"""The port's inline RL loop (``launch.run_inline``) on ``bandit_cpu`` on the
CPU, against a JAX package run of the same config: the loop trains and
pushes, and its streams carry messages with the JAX run's keys."""

import json
import os
import subprocess
import sys
from pathlib import Path

import torch

from pipelinerl_tpu_torch.config import compose
from pipelinerl_tpu_torch.launch import run_inline

REPO = Path(__file__).resolve().parent.parent
# one step of 32 samples is the 4 groups of 8 attempts: the actor stops
# early once the trainer is done, so a step of 16 (the preset's) let a
# loaded machine end the run after 2 or 3 groups
OVERRIDES = ["total_groups=4", "finetune.max_train_steps=1", "finetune.samples_per_step=32",
             "finetune.save_checkpoint_steps=0", "actor.publish_stats_every_n_groups=2"]


def first_message(exp, topic):
    with open(Path(exp) / "streams" / topic / "0" / "0.jsonl") as f:
        return json.loads(f.readline())


def test_run_inline_on_bandit_cpu_matches_the_jax_streams(tmp_path):
    torch.set_num_threads(2)
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    env.pop("XLA_FLAGS", None)
    jax_run = subprocess.Popen(
        [sys.executable, "-c", "from pipelinerl_tpu.launch import main; main()", f"output_dir={jax_dir}",
         "--config-dir=conf", "--config-name=bandit_cpu", *OVERRIDES],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    stats = run_inline(compose("bandit_cpu", [f"output_dir={port_dir}", *OVERRIDES]), device="cpu")
    out, err = jax_run.communicate(timeout=240)
    assert jax_run.returncode == 0, err[-3000:]
    assert stats["trainer"]["completed_steps"] >= 1
    assert stats["trainer"]["last_broadcasted_version"] > 0
    assert stats["actor"]["groups_completed"] == 4
    j_stats = json.loads(out.strip().splitlines()[-1])
    assert set(stats) == set(j_stats) and set(stats["trainer"]) == set(j_stats["trainer"])
    for topic in ("stats", "actor", "training_data", "weight_update_request"):
        assert set(first_message(port_dir, topic)) == set(first_message(jax_dir, topic)), topic
    assert (port_dir / "metrics" / "trainer_0.jsonl").exists()
