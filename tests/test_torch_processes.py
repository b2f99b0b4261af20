"""``launch_mode=processes`` on the CPU: the port's DRY_RUN start scripts
equal the JAX package's (module prefix and config file aside) for the device
job and the engine/trainer split, and one short bandit_cpu run in each
layout through the launcher's command line exits 0 with the trainer's steps
done, the engine on the trainer's last version, and no child left alive."""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

from pipelinerl_tpu import launch as jax_launch
from pipelinerl_tpu.config import compose as jax_compose
from pipelinerl_tpu_torch import launch
from pipelinerl_tpu_torch.config import compose

ROOT = Path(__file__).resolve().parents[1]
STEPS = 3


def scripts(exp: Path) -> dict[str, str]:
    return {p.name: p.read_text() for p in sorted(exp.glob("*/start_*.sh"))}


@pytest.mark.parametrize("layout", [[], ["+world.trainer_procs=1"], ["+world.ref_engine=true"]])
def test_dry_run_scripts_equal_jax(tmp_path, monkeypatch, layout):
    monkeypatch.setenv("DRY_RUN", "1")
    ov = [*layout, "launch_mode=processes"]
    assert launch.run_processes(compose("bandit_cpu", [*ov, f"output_dir={tmp_path}/port"])) == 0
    assert jax_launch.run_processes(jax_compose("conf", "bandit_cpu", [*ov, f"output_dir={tmp_path}/jax"])) == 0
    port, ref = scripts(tmp_path / "port"), scripts(tmp_path / "jax")
    assert port.keys() == ref.keys() and len(port) >= 3
    for name, text in ref.items():
        want = text.replace("pipelinerl_tpu.entrypoints.", "pipelinerl_tpu_torch.entrypoints.")
        assert port[name] == want.replace(f"{tmp_path}/jax/", f"{tmp_path}/port/"), name
    assert (tmp_path / "port" / "conf" / "exp_config.json").exists()
    assert not list((tmp_path / "port" / "logs").glob("*.out"))  # nothing was started


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def survivors(exp: Path) -> list[int]:
    """Processes whose command line names this run's config directory."""
    marker = f"--config-dir={exp}/conf".encode()
    found = []
    for proc in Path("/proc").iterdir():
        if proc.name.isdigit():
            try:
                if marker in (proc / "cmdline").read_bytes():
                    found.append(int(proc.name))
            except OSError:
                pass
    return found


@pytest.mark.parametrize("layout", ["device", "split"])
def test_short_run_in_each_layout(tmp_path, layout):
    exp = tmp_path / layout
    cmd = [sys.executable, "-m", "pipelinerl_tpu_torch.launch", "--config-name=bandit_cpu", f"output_dir={exp}",
           "launch_mode=processes", "device=cpu", f"finetune.max_train_steps={STEPS}", "total_groups=40",
           f"world.engine_start_port={free_port()}"]
    if layout == "split":
        cmd.append("world.trainer_procs=1")
    env = {**os.environ, "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1", "PYTHONPATH": str(ROOT)}
    try:
        proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    finally:
        for pid in survivors(exp):
            os.kill(pid, 9)
    assert proc.returncode == 0, proc.stderr[-4000:]
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    jobs = summary["jobs"]
    assert summary["exit_code"] == 0
    trainer = jobs["device_0" if layout == "device" else "trainer_0"]["trainer"]
    engine = jobs["device_0" if layout == "device" else "engine_0"]
    assert trainer["completed_steps"] == STEPS
    assert engine["version"] == trainer["last_broadcasted_version"] > 0
    if layout == "split":
        pushes = jobs["trainer_0"]["pushes"]
        # every version reached the engine as a PWT3 body
        assert engine["push"]["pushes_completed"] == engine["push"]["pushes_received"] == len(pushes) >= 2
        assert engine["push"]["push_last_version"] == pushes[-1]["version"] == trainer["last_broadcasted_version"]
    assert jobs["actor_0"]["actor"]["rollouts_completed"] > 0
    assert jobs["preprocessor_0"]["published_samples"] > 0
    assert not survivors(exp), "a child outlived the launcher"
