"""Engine job: the inference engine behind the HTTP server, its weights
updated in flight by PWT3 pushes to ``/receive_weight_update``; with
``me.frozen`` the KL reference policy, which refuses pushes.

    python -m pipelinerl_tpu_torch.entrypoints.run_engine --config-dir=<exp>/conf --config-name=exp_config +me.port=8080

It serves until SIGTERM, then writes its version, counters and kernel
launches to ``<output_dir>/<kind>/stats_<kind>_<replica>.json``.

One rank of a tp or pp engine (``+me.tp_rank``, its rank in the engine's
world, ``+me.tp_size``, ``+me.pp_size`` and ``+me.tp_coordinator``, which
the launcher gives each ``engine`` and ``engine_rank`` job at
``engine.tp * engine.pp`` above 1) joins the engine's world
(``inference/tp_ranks.py``) and keeps its stage's slice of the weights;
rank 0 serves HTTP and leads, the others follow its commands until it
stops.
"""

from __future__ import annotations

import logging

import signal

import torch

from ..inference.server import InferenceServer
from ..inference.tp_ranks import join_engine_world
from ..launch import build_engine, build_model, engine_params
from ..ops import kernel_launches
from ..parallel.multihost import leave_world
from .common import exit_on_sigterm, load_stage_config, serve_until_terminated, stage_device, stage_setup, write_stats

logger = logging.getLogger(__name__)


def main(argv: list[str] | None = None) -> None:
    cfg = load_stage_config(argv)
    frozen = bool(cfg.select("me.frozen", False))
    stage_setup(cfg, str(cfg.select("me.kind", "ref_engine" if frozen else "engine")))
    device = stage_device(cfg)
    tp_size, tp_rank = int(cfg.select("me.tp_size", 1) or 1), int(cfg.select("me.tp_rank", 0) or 0)
    pp_size = int(cfg.select("me.pp_size", 1) or 1)
    if tp_rank > 0:
        # a follower ends when rank 0 stops it (rank 0's SIGTERM does), so
        # that rank 0's last commands still find it
        signal.signal(signal.SIGTERM, signal.SIG_IGN)
    else:
        exit_on_sigterm()
    world = None
    if tp_size * pp_size > 1:
        world = join_engine_world(tp_rank, tp_size * pp_size, str(cfg.select("me.tp_coordinator")),
                                  torch.device(device), pp=pp_size)
    params, model_cfg, tokenizer = build_model(cfg, device)
    engine = build_engine(cfg, engine_params(params), model_cfg, tokenizer, device, tp_world=world)
    del params
    if tp_rank > 0:
        try:
            engine.serve_tp_worker()
        finally:
            write_stats(cfg, {"tp_rank": tp_rank, "version": engine.version, "window_digest": engine.window_digest,
                              "kernel_launches": kernel_launches()})
        leave_world()
        logger.info("Engine rank %d done at version %d", tp_rank, engine.version)
        return
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
                          "kernel_launches": kernel_launches(), "tp_rank": tp_rank, "tp_size": tp_size,
                          "pp_size": pp_size,
                          "window_digest": engine.window_digest})
        if world is not None:
            leave_world()
    logger.info("Engine job done at version %d", engine.version)


if __name__ == "__main__":
    main()
