"""Helpers shared by the stage entrypoints."""

from __future__ import annotations

import json
import os
import signal
import sys
import threading
import time
import urllib.request
from pathlib import Path

from ..config import Config, compose_saved
from ..streams import set_streams_backend
from ..utils import setup_logging


def load_stage_config(argv: list[str] | None = None) -> Config:
    """``--config-dir=<dir> --config-name=<name>`` (default
    ``conf/exp_config``) and ``key=value`` overrides → the stage's config."""
    argv = list(sys.argv[1:] if argv is None else argv)
    config_dir, config_name, overrides = "conf", "exp_config", []
    for arg in argv:
        if arg.startswith("--config-dir="):
            config_dir = arg.split("=", 1)[1]
        elif arg.startswith("--config-name="):
            config_name = arg.split("=", 1)[1]
        else:
            overrides.append(arg)
    return compose_saved(config_dir, config_name, overrides)


def stage_setup(cfg: Config, stage: str) -> str:
    """Log files under ``<output_dir>/logs/<stage>`` and the experiment's
    stream backend (``tcp`` routes every topic through ``streams.hub``; the
    hub itself serves and reads none); → the experiment directory."""
    exp_path = str(cfg.output_dir)
    setup_logging(Path(exp_path) / "logs" / stage)
    if stage != "stream_hub":
        set_streams_backend(str(cfg.select("streams.backend", "files") or "files"), hub=cfg.select("streams.hub"))
    return exp_path


def stage_device(cfg: Config) -> str:
    """The card, unless the config says ``device=cpu``: ``cuda:<slot %
    cards>`` where the launcher gave the job its place among its host's
    card jobs (``CARD_SLOT``, ``launch.card_slots``), else ``cuda``."""
    device = str(cfg.get("device", "cuda"))
    slot = os.environ.get("CARD_SLOT")
    if device != "cuda" or slot is None:
        return device
    import torch

    return f"cuda:{int(slot) % torch.cuda.device_count()}"


def build_tokenizer(cfg: Config):
    """The tokenizer of ``model_path`` without building the model: the toy
    tokenizer, or the port's byte-level BPE over the HF directory."""
    model_path = cfg.get("model_path")
    if model_path in (None, "toy"):
        from ..models.toy_tokenizer import ToyTokenizer

        return ToyTokenizer()
    from ..models.hf_tokenizer import HFTokenizer

    return HFTokenizer(model_path)


def write_stats(cfg: Config, stats: dict) -> Path:
    """``<output_dir>/<kind>/stats_<kind>_<replica>.json``, beside the job's
    start script."""
    kind = str(cfg.select("me.kind", "stage"))
    path = Path(str(cfg.output_dir)) / kind / f"stats_{kind}_{cfg.select('me.replica_idx', 0)}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".tmp")
    tmp.write_text(json.dumps(stats, default=str))
    tmp.replace(path)
    return path


def wait_for_http(urls: list[str], timeout: float = 600.0, procs: list = ()) -> None:
    """Block until every URL's ``/health`` answers 200; fail at once if one
    of ``procs`` (``(name, Popen)`` pairs) has exited."""
    deadline = time.monotonic() + timeout
    for url in urls:
        while True:
            try:
                with urllib.request.urlopen(f"{url}/health", timeout=5) as resp:
                    if resp.status == 200:
                        break
            except Exception:  # noqa: BLE001 - not up yet
                pass
            dead = [(name, p.returncode) for name, p in procs if p.poll() is not None]
            if dead:
                raise RuntimeError(f"job(s) {dead} exited before {url} became healthy")
            if time.monotonic() > deadline:
                raise TimeoutError(f"Server {url} failed to become healthy")
            time.sleep(0.5)


def exit_on_sigterm() -> None:
    """SIGTERM raises SystemExit in the main thread, wherever it is (a train
    step, or a serving job's wait), so ``finally`` blocks shut the server
    and engine down and write the job's stats."""

    def handler(signum, frame):
        raise SystemExit(128 + signum)

    signal.signal(signal.SIGTERM, handler)


def serve_until_terminated() -> None:
    threading.Event().wait()
