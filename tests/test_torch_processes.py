"""``launch_mode=processes`` on the CPU: the port's DRY_RUN start scripts
and launch commands equal the JAX package's (module prefix and config file
aside) for the device job, the engine/trainer split, the reference engine,
the stream hub, environment servers and a job on another host (ssh); one
short bandit_cpu run in each layout through the launcher's command line
exits 0 with the trainer's steps done, the engine on the trainer's last
version, and no child left alive; and the ``logic`` preset runs through the
stream hub with a verifier server and evals."""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest
import yaml

from pipelinerl_tpu import launch as jax_launch
from pipelinerl_tpu.config import compose as jax_compose
from pipelinerl_tpu_torch import launch
from pipelinerl_tpu_torch.config import compose

ROOT = Path(__file__).resolve().parents[1]
STEPS = 3


def scripts(exp: Path) -> dict[str, str]:
    return {p.name: p.read_text() for p in sorted(exp.glob("*/start_*.sh"))}


def dry_run_commands(exp: Path) -> list[list[str]]:
    """The commands the launcher logged under DRY_RUN, in launch order."""
    lines = (exp / "logs" / "launcher" / "info.log").read_text().splitlines()
    return [line.split("DRY_RUN: ", 1)[1].split(" ") for line in lines if "DRY_RUN: " in line]


LAYOUTS = {
    "device": [],
    "split": ["+world.trainer_procs=1"],
    "trainer_world": ["+world.trainer_procs=2"],
    "ref_engine": ["+world.ref_engine=true"],
    "stream_hub": ["+world.stream_hub=true", "+world.stream_hub_port=7301", "+streams.hub_maxlen=1000"],
    "environment": ["+environment_class=env.Server", "world.env_replicas=2"],
    "local_hosts": ["+world.hosts=[127.0.0.1,localhost]", "+environment_class=env.Server", "world.env_replicas=2"],
    "ssh": ["+world.hosts=[127.0.0.1,10.0.0.2]", "+environment_class=env.Server", "world.env_replicas=2",
            "world.replicas=2", "+actor.replicas=2"],
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_dry_run_scripts_equal_jax(tmp_path, monkeypatch, layout):
    """The start scripts equal JAX's; the commands start in the same order
    (the hub, then the environment servers and card jobs, then the host
    stages), and a job on another host runs as ``ssh <host> env
    <assignments> <command>`` as JAX's does (the assignments are each
    package's own: its path, and no card for a host-only job)."""
    monkeypatch.setenv("DRY_RUN", "1")
    ov = [*LAYOUTS[layout], "launch_mode=processes"]
    assert launch.run_processes(compose("bandit_cpu", [*ov, f"output_dir={tmp_path}/port"])) == 0
    assert jax_launch.run_processes(jax_compose("conf", "bandit_cpu", [*ov, f"output_dir={tmp_path}/jax"])) == 0
    port, ref = scripts(tmp_path / "port"), scripts(tmp_path / "jax")
    assert port.keys() == ref.keys() and len(port) >= 3

    def as_port(text: str) -> str:
        text = text.replace("pipelinerl_tpu.entrypoints.", "pipelinerl_tpu_torch.entrypoints.")
        return text.replace(f"{tmp_path}/jax/", f"{tmp_path}/port/")

    for name, text in ref.items():
        assert port[name] == as_port(text), name
    port_cmds, ref_cmds = dry_run_commands(tmp_path / "port"), dry_run_commands(tmp_path / "jax")
    assert len(port_cmds) == len(ref_cmds) == len(port)
    for got, want in zip(port_cmds, ref_cmds):
        if want[0] == "ssh":
            assert got[:3] == want[:3] and want[1] == "10.0.0.2"
            got_assigns, got = got[3 : got.index(sys.executable)], got[got.index(sys.executable):]
            want = want[want.index(sys.executable):]
            kind = next(a for a in got if a.startswith("+me.kind=")).split("=")[1]
            assert f"PYTHONPATH={ROOT}" in got_assigns[0]
            assert ("CUDA_VISIBLE_DEVICES=" in got_assigns) == (kind not in launch.CARD_JOBS)
        assert got == as_port(" ".join(want)).split(" ")
    n_ssh = sum(c[0] == "ssh" for c in port_cmds)
    assert n_ssh == (3 if layout == "ssh" else 0)  # device_1, environment_1, actor_1 on 10.0.0.2
    saved = json.loads((tmp_path / "port" / "conf" / "exp_config.json").read_text())
    if "+environment_class=env.Server" in ov:
        assert saved["environment"] == [{"hostname": j["hostname"], "port": j["port"]}
                                        for j in saved["jobs"] if j["kind"] == "environment"]
    hub = next((j for j in saved["jobs"] if j["kind"] == "stream_hub"), None)
    if hub is not None:
        assert saved["streams"]["backend"] == "tcp" and saved["streams"]["hub"] == f"{hub['hostname']}:{hub['port']}"
    if layout == "stream_hub":
        # the hub's own settings reach it; JAX's launcher replaces the whole
        # streams node, so there the hub keeps its defaults
        assert saved["streams"]["hub_maxlen"] == 1000
        jax_saved = yaml.safe_load((tmp_path / "jax" / "conf" / "exp_config.yaml").read_text())
        assert "hub_maxlen" not in jax_saved["streams"]
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


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    from pipelinerl_tpu.models.hf_fixture import build_hf_checkpoint

    return build_hf_checkpoint(tmp_path_factory.mktemp("hf_fixture"), dtype="float32")


def test_logic_preset_through_the_hub_and_a_verifier(tmp_path, hf_dir):
    """The ``logic`` preset in processes mode on the CPU over two local host
    names: the stream hub starts (every topic rides it), one
    ``LogicEnvironment`` job grades every rollout over RPC, and an eval runs
    after each version. The hub's ``.scf`` mirror holds what the stages
    report, and no child outlives the launcher."""
    from tests.test_torch_domains_e2e import CUTS

    exp = tmp_path / "logic"
    ports = [free_port() for _ in range(3)]
    cmd = [sys.executable, "-m", "pipelinerl_tpu_torch.launch", "--config-name=logic", f"model_path={hf_dir}",
           f"output_dir={exp}", "launch_mode=processes", *CUTS, "finetune.max_train_steps=3", "max_lag=0",
           "test_llm.parameters.max_tokens=24", "eval_every_n_versions=1", "test_subset=2",
           "world.hosts=[127.0.0.1,localhost]", "world.env_replicas=1", f"world.engine_start_port={ports[0]}",
           f"world.stream_hub_port={ports[1]}", f"world.environment_start_port={ports[2]}"]
    env = {**os.environ, "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1", "PYTHONPATH": str(ROOT)}
    try:
        proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    finally:
        for pid in survivors(exp):
            os.kill(pid, 9)
    assert proc.returncode == 0, proc.stderr[-4000:]
    jobs = json.loads(proc.stdout.strip().splitlines()[-1])["jobs"]
    trainer, device = jobs["device_0"]["trainer"], jobs["device_0"]
    assert trainer["completed_steps"] == 3 and device["version"] == trainer["last_broadcasted_version"] > 0
    assert jobs["environment_0"]["requests"]["/verify_answer"]["200"] >= jobs["actor_0"]["actor"]["rollouts_completed"]
    keys = jobs["stream_hub_0"]["keys"]
    persisted = {}
    for key in ("actor/0/0", "training_data/0/0", "stats_test/0/0", "weight_update_request/0/0"):
        persisted[key] = list(t_bin_reader(exp / "streams_hub" / f"{key}.scf"))
        assert len(persisted[key]) == keys[key]["messages"] > 0, key
    assert len(persisted["actor/0/0"]) == jobs["actor_0"]["actor"]["groups_completed"]
    assert sum(b["num_sequences"] for b in persisted["training_data/0/0"]) == jobs["preprocessor_0"]["published_samples"]
    evals = jobs["actor_0"]["evals"]
    assert evals and evals[0]["groups"] == 2 and len(persisted["stats_test/0/0"]) == len(evals)
    assert not list((exp / "streams").glob("*/0/0.jsonl")), "a topic bypassed the hub"
    assert not survivors(exp), "a child outlived the launcher"


def t_bin_reader(path: Path):
    from pipelinerl_tpu_torch.streams_binary import FrameReader

    return FrameReader(path).read_available()
