"""Actor job: grouped rollouts against the engine servers over HTTP
(``HTTPLLM``), written to the actor stream; host only, it imports no model
and no kernel. Eval interleaving is not ported yet (ROADMAP Queue 1,
item 5); ``launch.validate_config`` refuses it."""

from __future__ import annotations

import asyncio
import logging

from ..actor import ActorLoop
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
    problems = resolve(cfg.dataset_loader)(list(cfg.get("train_dataset_names", ["train"])))
    if cfg.get("train_subset"):
        problems = problems[: int(cfg.train_subset)]
    actor = ActorLoop(cfg, llms, problems, trainer_state, exp_path, resolve(cfg.rollout_policy))
    try:
        stats = await actor.run(total_groups=cfg.get("total_groups"))
    finally:
        trainer_state.stop()
    return stats.snapshot()


def main(argv: list[str] | None = None) -> None:
    cfg = load_stage_config(argv)
    snapshot = asyncio.run(amain(cfg))
    write_stats(cfg, {"actor": snapshot})
    logger.info("Actor done: %s", snapshot)


if __name__ == "__main__":
    main()
