"""Environment-server job: the class named by ``environment_class`` (the
math verifier by default) served on ``me.port``; host only, it imports no
model and no kernel.

    python -m pipelinerl_tpu_torch.entrypoints.run_environment --config-dir=<exp>/conf --config-name=exp_config +me.port=7777

It serves until SIGTERM, then writes its request log (per route, the count
of each status answered) to ``<output_dir>/environment/stats_environment_<replica>.json``.
"""

from __future__ import annotations

import logging

from ..domains.registry import resolve
from .common import exit_on_sigterm, load_stage_config, serve_until_terminated, stage_setup, write_stats

logger = logging.getLogger(__name__)

DEFAULT_ENV_CLASS = "pipelinerl_tpu_torch.domains.math.verifier_api.MathEnvironment"


def main(argv: list[str] | None = None) -> None:
    cfg = load_stage_config(argv)
    stage_setup(cfg, "environment")
    exit_on_sigterm()
    port = int(cfg.select("me.port", 7777))
    env_class_path = cfg.get("environment_class") or DEFAULT_ENV_CLASS
    logger.info("Launching environment %s on port %d", env_class_path, port)
    env = resolve(env_class_path)()
    env.start(port=port)
    try:
        serve_until_terminated()
    finally:
        env.shutdown()
        write_stats(cfg, {"environment_class": env_class_path, "port": port, "requests": env.request_log()})


if __name__ == "__main__":
    main()
