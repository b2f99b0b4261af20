"""Reap every process a run starts, however the run ends.

A run is a thin parent and one child that does the work. The parent gives
the child a run marker in its environment (``CHIP_SMOKE_RUN=<uuid4>``),
which every descendant inherits whatever its session, and a temporary
directory of the run (``CHIP_SMOKE_TMP``, also the child's ``TMPDIR``), which
the command lines of jobs started through ssh carry (ssh forwards only a few
variables). When the child ends, by an exit, a crash or a signal, the parent
sweeps: it finds every process whose ``/proc/<pid>/environ`` holds the
marker or whose ``/proc/<pid>/cmdline`` holds the directory, sends SIGTERM,
waits briefly and sends SIGKILL. It exits with the child's code (128 + the
signal if a signal ended the child), and with 1 if an ok child left a
process behind, naming it on stderr; it writes nothing to stdout.

    python -m pipelinerl_tpu_torch.reaper CMD [ARGS ...]

``chip_smoke.py`` runs itself this way. Stdlib only, so the parent stays
thin.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time
import uuid

MARKER = "CHIP_SMOKE_RUN"
RUN_TMP = "CHIP_SMOKE_TMP"
PR_SET_PDEATHSIG = 1


def marked(marker: str, tmp: str | None = None, exclude: tuple[int, ...] = ()) -> list[tuple[int, str]]:
    """(pid, command line) of each live process that carries ``marker`` in
    its environment or ``tmp`` in its command line, but this process and
    ``exclude``. A zombie's environment and command line read empty, so it
    is not listed."""
    needle = f"{MARKER}={marker}".encode()
    skip = {os.getpid(), *exclude}
    found = []
    for entry in os.scandir("/proc"):
        if not entry.name.isdigit() or int(entry.name) in skip:
            continue
        try:
            with open(f"/proc/{entry.name}/cmdline", "rb") as f:
                cmdline = f.read()
            with open(f"/proc/{entry.name}/environ", "rb") as f:
                hit = needle in f.read().split(b"\0")
        except OSError:  # gone, or not ours to read
            continue
        if hit or (tmp and tmp.encode() in cmdline):
            found.append((int(entry.name), cmdline.replace(b"\0", b" ").decode(errors="replace").strip()))
    return found


def _signal_all(procs: list[tuple[int, str]], sig: int) -> None:
    for pid, _ in procs:
        try:
            os.kill(pid, sig)
        except (ProcessLookupError, PermissionError):
            pass


def sweep(marker: str, tmp: str | None = None, grace: float = 5.0,
          exclude: tuple[int, ...] = ()) -> list[tuple[int, str]]:
    """Kill every process ``marked`` finds: SIGTERM, up to ``grace``
    seconds for them to go, then SIGKILL to whatever still carries the
    marker (read again, so a reused pid is spared). → the processes found."""
    found = marked(marker, tmp, exclude)
    if not found:
        return []
    _signal_all(found, signal.SIGTERM)
    deadline = time.monotonic() + grace
    left = found
    while left and time.monotonic() < deadline:
        time.sleep(0.1)
        left = marked(marker, tmp, exclude)
    for _ in range(10):  # a process may start another while it dies
        if not left:
            break
        _signal_all(left, signal.SIGKILL)
        time.sleep(0.1)
        seen = {pid for pid, _ in found}
        found += [p for p in left if p[0] not in seen]
        left = marked(marker, tmp, exclude)
    return found


def sweep_run(grace: float = 5.0) -> list[tuple[int, str]]:
    """``sweep`` of the run this process belongs to (its marker and
    directory from the environment), sparing this process; nothing outside
    a run."""
    marker = os.environ.get(MARKER)
    return sweep(marker, os.environ.get(RUN_TMP), grace) if marker else []


def describe(procs: list[tuple[int, str]]) -> str:
    return "; ".join(f"pid {pid}: {cmd[:300]}" for pid, cmd in procs)


def _die_with_parent() -> None:
    """In the child before its exec: SIGTERM when the parent dies, even by
    SIGKILL (Linux's PR_SET_PDEATHSIG), so ``guard_child``'s handler sweeps."""
    try:
        ctypes.CDLL(None, use_errno=True).prctl(PR_SET_PDEATHSIG, signal.SIGTERM)
    except (OSError, AttributeError):
        pass


def guard_child() -> None:
    """In a run's child: on SIGTERM (the parent forwarding a signal, or the
    parent's death) sweep the run's other processes, then exit 143."""
    def on_term(signum, frame):
        sweep_run(grace=2.0)
        os._exit(128 + signum)

    signal.signal(signal.SIGTERM, on_term)


def run_parent(cmd: list[str], grace: float = 5.0) -> int:
    """Run ``cmd`` as a run's one child, wait, sweep, and → the exit code:
    the child's, 128 + the signal that ended it, or 1 where an ok child
    left a process that the sweep had to kill. SIGTERM, SIGINT and SIGHUP
    are forwarded to the child."""
    marker = uuid.uuid4().hex
    tmp = tempfile.mkdtemp(prefix=f"run_{marker[:8]}_")
    env = dict(os.environ, **{MARKER: marker, RUN_TMP: tmp, "TMPDIR": tmp})
    child = subprocess.Popen(cmd, env=env, preexec_fn=_die_with_parent)

    def forward(signum, frame):
        try:
            child.send_signal(signum)
        except ProcessLookupError:
            pass

    for sig in (signal.SIGTERM, signal.SIGINT, signal.SIGHUP):
        signal.signal(sig, forward)
    code = child.wait()
    left = sweep(marker, tmp, grace)
    shutil.rmtree(tmp, ignore_errors=True)
    if code < 0:
        print(f"reaper: the child ended by signal {-code} ({signal.Signals(-code).name})", file=sys.stderr)
        code = 128 - code
    if left:
        print(f"reaper: {len(left)} process(es) outlived the child and were killed: {describe(left)}",
              file=sys.stderr)
        if code == 0:
            code = 1
    return code


if __name__ == "__main__":
    if len(sys.argv) < 2:
        sys.exit("usage: python -m pipelinerl_tpu_torch.reaper CMD [ARGS ...]")
    sys.exit(run_parent(sys.argv[1:]))
