"""Actor job: grouped rollouts against the engine servers over HTTP
(``HTTPLLM``), written to the actor stream, with an eval of the test
problems every ``eval_every_n_versions`` weight versions (``actor_test``
and ``stats_test``); host only, it imports no model and no kernel. Under
``debug.mode`` it starts at version 0 without waiting for a trainer. Its
stats file holds the run's last snapshot and the evals it ran."""

from __future__ import annotations

import asyncio
import logging

from ..actor import ActorLoop, load_test_problems, run_with_evals
from ..domains.registry import resolve
from ..inference.http_client import HTTPLLM
from ..state import TrainerState
from .common import build_tokenizer, load_stage_config, stage_setup, write_stats

logger = logging.getLogger(__name__)


async def amain(cfg) -> dict:
    exp_path = stage_setup(cfg, "actor")
    tokenizer = build_tokenizer(cfg)
    urls = list(cfg.select("me.llm_urls", []) or [])
    if not urls:
        urls = [f"http://127.0.0.1:{cfg.select('world.engine_start_port', 8080)}"]
    llms = [HTTPLLM(url, tokenizer, dict(cfg.llm.parameters.items())) for url in urls]
    trainer_state = TrainerState(exp_path)
    trainer_state.start_listening()
    if cfg.select("debug.mode"):
        trainer_state.debug_mode_init()
    try:
        await asyncio.get_running_loop().run_in_executor(None, trainer_state.wait_for_model_version, 0)
        problems = resolve(cfg.dataset_loader)(list(cfg.get("train_dataset_names", ["train"])))
        if cfg.get("train_subset"):
            problems = problems[: int(cfg.train_subset)]
        test_problems = load_test_problems(cfg)
        test_llms = [HTTPLLM(url, tokenizer, dict(cfg.test_llm.parameters.items())) for url in urls]
        actor = ActorLoop(cfg, llms, problems, trainer_state, exp_path, resolve(cfg.rollout_policy))
        stats, evals = await run_with_evals(actor, test_llms, test_problems, cfg.get("total_groups"))
    finally:
        trainer_state.stop()
    return {"actor": stats.snapshot(), "evals": evals}


def main(argv: list[str] | None = None) -> None:
    cfg = load_stage_config(argv)
    out = asyncio.run(amain(cfg))
    write_stats(cfg, out)
    logger.info("Actor done: %s", out)


if __name__ == "__main__":
    main()
