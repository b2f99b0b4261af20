"""Preprocessor job: advantages and packing between the actor stream and
the trainer's partitions; host only. With a KL penalty it scores reference
logprobs over HTTP on the frozen reference engine (``HTTPLLM.ascore``)."""

from __future__ import annotations

import asyncio
import logging

from ..inference.http_client import HTTPLLM
from ..preprocess import Preprocessor
from ..state import TrainerState
from ..world import WorldMap
from .common import build_tokenizer, load_stage_config, stage_setup, write_stats

logger = logging.getLogger(__name__)


def main(argv: list[str] | None = None) -> None:
    cfg = load_stage_config(argv)
    exp_path = stage_setup(cfg, "preprocessor")
    tokenizer = build_tokenizer(cfg)
    trainer_state = TrainerState(exp_path)
    trainer_state.start_listening()
    ref_score_fn = None
    ref_urls = list(cfg.select("me.ref_llm_urls", []) or [])
    if float(cfg.finetune.rl.get("kl_coef", 0.0) or 0.0) != 0.0 and ref_urls:
        ref_llm = HTTPLLM(ref_urls[0], tokenizer)

        def ref_score_fn(token_ids):
            return asyncio.run(ref_llm.ascore(token_ids))

    preprocessor = Preprocessor(
        cfg, exp_path, trainer_state, eos_token_id=tokenizer.eos_token_id,
        num_trainers=WorldMap(cfg).num_trainers,
        ref_score_fn=ref_score_fn,
    )
    try:
        preprocessor.run()
    finally:
        trainer_state.stop()
    write_stats(cfg, {"published_samples": preprocessor.published_samples,
                      "dropped_old_samples": preprocessor.dropped_old_samples})
    logger.info("Preprocessor done")


if __name__ == "__main__":
    main()
