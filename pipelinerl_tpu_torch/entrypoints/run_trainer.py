"""Trainer job: one trainer process; every weight update is serialized as a
PWT3 body and POSTed to every engine server in parallel
(``push_weights_http``), each answering once it serves the new version.

    python -m pipelinerl_tpu_torch.entrypoints.run_trainer --config-dir=<exp>/conf --config-name=exp_config '+me.llm_urls=["http://127.0.0.1:8080"]'

It waits for the engines' ``/health`` before its first push, and at the
end writes its summary, its pushes' timings and its kernel launches to
``<output_dir>/trainer/stats_trainer_0.json``. A sharded trainer world
(``world.trainer_procs`` > 1) waits for ROADMAP Queue 1 item 8.
"""

from __future__ import annotations

import logging

from ..inference.weight_transfer import push_weights_http
from ..launch import build_model
from ..train.trainer import TrainerLoop, summary
from ..ops import kernel_launches
from .common import load_stage_config, stage_device, stage_setup, wait_for_http, write_stats

logger = logging.getLogger(__name__)


def main(argv: list[str] | None = None) -> None:
    cfg = load_stage_config(argv)
    exp_path = stage_setup(cfg, "trainer")
    if int(cfg.select("me.num_processes", 1)) > 1:
        raise NotImplementedError("a trainer world of more than one process is not ported yet (ROADMAP Queue 1, item 8)")
    params, model_cfg, _ = build_model(cfg, stage_device(cfg))
    llm_urls = list(cfg.select("me.llm_urls", []) or [])
    pushes: list[dict] = []

    def push(new_params: dict, version: int) -> None:
        timings = push_weights_http(llm_urls, new_params, version)
        pushes.append({"version": version, **{k: timings[k] for k in ("bytes", "serialize_s", "post_s")}})

    trainer = TrainerLoop(cfg, params, model_cfg, exp_path, weight_update_cb=push if llm_urls else None)
    wait_for_http(llm_urls)
    trainer.run()
    write_stats(cfg, {"trainer": summary(trainer.metrics), "pushes": pushes, "kernel_launches": kernel_launches()})
    logger.info("Trainer done: %d pushes", len(pushes))


if __name__ == "__main__":
    main()
