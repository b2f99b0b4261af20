"""Trainer job: one rank of the trainer world; every weight update is
serialized as a PWT3 body and POSTed to every engine server in parallel
(``push_weights_http``), each answering once it serves the new version.

    python -m pipelinerl_tpu_torch.entrypoints.run_trainer --config-dir=<exp>/conf --config-name=exp_config '+me.llm_urls=["http://127.0.0.1:8080"]'

A world of more than one rank (``+me.process_id``, ``+me.num_processes``,
``+me.coordinator``, which the launcher passes every trainer job) joins one
``torch.distributed`` group (``parallel/multihost.py``) and trains one
``(dp, cp)`` mesh; each rank reads the ``training_data`` partition of its
dp rank. Every rank joins the gather of the full weights for a push; rank 0
POSTs them (JAX ``gather_for_push``). Rank 0 waits for the engines'
``/health`` before its first push. At the end each rank writes its
summary, its pushes' timings and its kernel launches to
``<output_dir>/trainer/stats_trainer_<rank>.json``.
"""

from __future__ import annotations

import logging

from ..inference.weight_transfer import push_weights_http
from ..launch import build_model
from ..ops import kernel_launches
from ..parallel.multihost import leave_world, maybe_initialize_distributed, world_settings
from ..train.trainer import TrainerLoop, summary
from .common import load_stage_config, stage_device, stage_setup, wait_for_http, write_stats

logger = logging.getLogger(__name__)


def main(argv: list[str] | None = None) -> None:
    cfg = load_stage_config(argv)
    exp_path = stage_setup(cfg, "trainer")
    rank, world, _ = world_settings(cfg)
    _, device = maybe_initialize_distributed(cfg, stage_device(cfg))
    params, model_cfg, _ = build_model(cfg, str(device))
    llm_urls = list(cfg.select("me.llm_urls", []) or [])
    pushes: list[dict] = []

    def push(new_params: dict, version: int) -> None:
        # every rank has joined the gather (TrainerLoop.served_params)
        if rank != 0:
            return
        timings = push_weights_http(llm_urls, new_params, version)
        pushes.append({"version": version, **{k: timings[k] for k in ("bytes", "serialize_s", "post_s")}})

    trainer = TrainerLoop(cfg, params, model_cfg, exp_path, weight_update_cb=push if llm_urls else None)
    del params  # a world's trainer keeps its shards
    if rank == 0:
        wait_for_http(llm_urls)
    trainer.run()
    leave_world()
    write_stats(cfg, {"trainer": summary(trainer.metrics), "rank": rank, "world": world, "pushes": pushes,
                      "kernel_launches": kernel_launches()})
    logger.info("Trainer rank %d/%d done: %d pushes", rank, world, len(pushes))


if __name__ == "__main__":
    main()
