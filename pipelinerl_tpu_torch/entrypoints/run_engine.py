"""Engine job: the inference engine behind the HTTP server, its weights
updated in flight by PWT3 pushes to ``/receive_weight_update``; with
``me.frozen`` the KL reference policy, which refuses pushes.

    python -m pipelinerl_tpu_torch.entrypoints.run_engine --config-dir=<exp>/conf --config-name=exp_config +me.port=8080

It serves until SIGTERM, then writes its version, counters and kernel
launches to ``<output_dir>/<kind>/stats_<kind>_<replica>.json``.
"""

from __future__ import annotations

import logging

from ..inference.server import InferenceServer
from ..launch import build_engine, build_model, engine_params
from ..ops import kernel_launches
from .common import exit_on_sigterm, load_stage_config, serve_until_terminated, stage_device, stage_setup, write_stats

logger = logging.getLogger(__name__)


def main(argv: list[str] | None = None) -> None:
    cfg = load_stage_config(argv)
    frozen = bool(cfg.select("me.frozen", False))
    stage_setup(cfg, "ref_engine" if frozen else "engine")
    device = stage_device(cfg)
    exit_on_sigterm()
    params, model_cfg, tokenizer = build_model(cfg, device)
    engine = build_engine(cfg, engine_params(params), model_cfg, tokenizer, device)
    del params
    engine.start()
    server = InferenceServer(engine, tokenizer, frozen=frozen)
    server.start(port=int(cfg.select("me.port", 8080)))
    try:
        serve_until_terminated()
    finally:
        server.shutdown()
        engine.stop()
        write_stats(cfg, {"version": engine.version, "counters": engine.perf_counters(),
                          "push": engine.push_counters(), "last_push": engine.last_push_timings,
                          "kernel_launches": kernel_launches()})
    logger.info("Engine job done at version %d", engine.version)


if __name__ == "__main__":
    main()
