"""The smoke's reaper (``pipelinerl_tpu_torch/reaper.py``) on the CPU: a
parent runs a middle process that starts grandchildren in sessions of their
own (one of them without the run's marker in its environment, as a job
started over ssh, but with the run's directory on its command line); the
middle then dies by SIGKILL or SIGSEGV, or by the SIGTERM the parent
forwards when it gets one, or exits 0 with the grandchildren still
running, or exits 0 after its own sweep stopped them. No marked process may be
left, and the parent's code says how the child ended."""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest

from pipelinerl_tpu_torch import reaper

ROOT = Path(__file__).resolve().parents[1]

MIDDLE = r"""
import json, os, resource, signal, subprocess, sys, time
resource.setrlimit(resource.RLIMIT_CORE, (0, 0))
out, mode = sys.argv[1], sys.argv[2]
tmp = os.environ["CHIP_SMOKE_TMP"]
sleeper = [sys.executable, "-c", "import time; time.sleep(120)"]
kids = [subprocess.Popen(sleeper, start_new_session=True) for _ in range(2)]
bare = {k: v for k, v in os.environ.items() if k not in ("CHIP_SMOKE_RUN", "CHIP_SMOKE_TMP")}
kids.append(subprocess.Popen([*sleeper, f"--config-dir={tmp}/conf"], env=bare, start_new_session=True))
# a grandchild's own child, two sessions down
kids.append(subprocess.Popen([sys.executable, "-c", "import subprocess, sys, time; "
                              "subprocess.Popen([sys.executable, '-c', 'import time; time.sleep(120)'], "
                              "start_new_session=True); time.sleep(120)"], start_new_session=True))
time.sleep(0.5)
with open(out + ".part", "w") as f:
    json.dump({"pid": os.getpid(), "kids": [k.pid for k in kids], "marker": os.environ["CHIP_SMOKE_RUN"],
               "tmp": tmp}, f)
os.rename(out + ".part", out)
while mode in ("leak", "clean") and not os.path.exists(out + ".go"):
    time.sleep(0.05)
if mode == "leak":
    sys.exit(0)
if mode == "clean":  # the child's own sweep, as the smoke's before its last line
    from pipelinerl_tpu_torch import reaper
    sys.exit(0 if len(reaper.sweep_run()) == 5 else 3)
time.sleep(120)
"""


def alive(pid: int) -> bool:
    """True while ``pid`` runs: a zombie (its parent gone, or not yet
    reaped) has ended."""
    try:
        return Path(f"/proc/{pid}/stat").read_text().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


@pytest.mark.parametrize("mode, want", [("sigkill", 128 + signal.SIGKILL), ("sigsegv", 128 + signal.SIGSEGV),
                                        ("leak", 1), ("clean", 0), ("parent_sigterm", 128 + signal.SIGTERM)])
def test_the_parent_reaps_every_descendant(tmp_path, mode, want):
    out = tmp_path / "tree.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    env.pop(reaper.MARKER, None)
    parent = subprocess.Popen([sys.executable, "-m", "pipelinerl_tpu_torch.reaper", sys.executable, "-c", MIDDLE,
                               str(out), mode], env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)
    try:
        deadline = time.monotonic() + 60
        while not out.exists():
            assert parent.poll() is None and time.monotonic() < deadline, parent.stderr.read()
            time.sleep(0.05)
        tree = json.loads(out.read_text())
        assert len(reaper.marked(tree["marker"], tree["tmp"])) >= 5  # the middle, 4 grandchildren, 1 below
        if mode in ("sigkill", "sigsegv"):
            os.kill(tree["pid"], signal.SIGKILL if mode == "sigkill" else signal.SIGSEGV)
        elif mode == "parent_sigterm":  # the parent forwards it to the child, then sweeps
            parent.send_signal(signal.SIGTERM)
        else:
            Path(f"{out}.go").touch()
        stdout, stderr = parent.communicate(timeout=60)
    finally:
        if parent.poll() is None:
            parent.kill()
            parent.wait(timeout=10)
    assert parent.returncode == want, stderr
    assert stdout == ""  # the child's last line stays the last line
    assert reaper.marked(tree["marker"], tree["tmp"]) == []
    assert not any(alive(pid) for pid in tree["kids"])
    assert not Path(tree["tmp"]).exists()
    if mode == "leak":
        assert "outlived the child" in stderr and str(tree["kids"][0]) in stderr
    if mode == "sigsegv":
        assert "SIGSEGV" in stderr


def test_sweep_spares_processes_outside_the_run(tmp_path):
    """A process without the marker or the run's directory lives on; a
    marked one started here is swept, SIGTERM first."""
    env = dict(os.environ, **{reaper.MARKER: "test-run-" + tmp_path.name})
    sleeper = [sys.executable, "-c", "import time; time.sleep(60)"]
    outside = subprocess.Popen(sleeper)
    inside = subprocess.Popen(sleeper, env=env, start_new_session=True)
    try:
        time.sleep(0.3)
        found = reaper.sweep(env[reaper.MARKER], str(tmp_path / "run"), grace=5.0)
        assert [pid for pid, _ in found] == [inside.pid]
        assert inside.wait(timeout=10) == -signal.SIGTERM
        assert outside.poll() is None
    finally:
        for p in (outside, inside):
            p.kill()
            p.wait(timeout=10)
