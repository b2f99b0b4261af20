"""Device job: engine, HTTP server and trainer in one CUDA process; the
trainer's weight updates are in-process swaps of copies.

    python -m pipelinerl_tpu_torch.entrypoints.run_device --config-dir=<exp>/conf --config-name=exp_config +me.port=8080

When the trainer is done it writes its summary, then serves on until
SIGTERM (actors may still have requests in flight), and last writes the
engine's counters and the process's kernel launches to
``<output_dir>/device/stats_device_<replica>.json``.
"""

from __future__ import annotations

import logging

from ..inference.server import InferenceServer
from ..launch import build_engine, build_model, engine_params
from ..train.trainer import TrainerLoop, summary
from ..ops import kernel_launches
from .common import exit_on_sigterm, load_stage_config, serve_until_terminated, stage_device, stage_setup, write_stats

logger = logging.getLogger(__name__)


def main(argv: list[str] | None = None) -> None:
    cfg = load_stage_config(argv)
    exp_path = stage_setup(cfg, "device")
    device = stage_device(cfg)
    exit_on_sigterm()
    params, model_cfg, tokenizer = build_model(cfg, device)
    # the engine owns copies: AdamW updates the trainer's tensors in place
    engine = build_engine(cfg, engine_params(params), model_cfg, tokenizer, device)
    engine.start()
    server = InferenceServer(engine, tokenizer)
    server.start(port=int(cfg.select("me.port", 8080)))
    trainer = TrainerLoop(cfg, params, model_cfg, exp_path, weight_update_cb=engine.update_params,
                          device_quiesce=engine.quiesced)
    stats: dict = {}
    try:
        trainer.run()
        stats["trainer"] = summary(trainer.metrics)
        write_stats(cfg, {**stats, "kernel_launches": kernel_launches()})
        logger.info("Trainer done; serving until stopped")
        serve_until_terminated()
    finally:
        server.shutdown()
        engine.stop()
        write_stats(cfg, {**stats, "version": engine.version, "counters": engine.perf_counters(),
                          "kernel_launches": kernel_launches()})
    logger.info("Device job done")


if __name__ == "__main__":
    main()
