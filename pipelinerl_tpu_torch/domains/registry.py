"""Dotted-path function resolution and multi-domain dispatch.

Port of the JAX package's ``domains/registry.py`` with every domain of its
table.
"""

from __future__ import annotations

import importlib
from typing import Any, Callable

DEFAULT_DOMAIN_ROLLOUTS: dict[str, str] = {
    "guessing": "pipelinerl_tpu_torch.domains.guessing.generate_guessing_rollout",
    "counting": "pipelinerl_tpu_torch.domains.counting.generate_counting_rollout",
    "bandit": "pipelinerl_tpu_torch.domains.bandit.generate_bandit_rollout",
    "math": "pipelinerl_tpu_torch.domains.math.rollouts.generate_math_rollout",
    "tir": "pipelinerl_tpu_torch.domains.tir.rollouts.generate_tir_rollout",
    "coding": "pipelinerl_tpu_torch.domains.coding.rollouts.generate_coding_rollout",
    "fn_calling": "pipelinerl_tpu_torch.domains.fn_calling.rollouts.generate_fn_calling_rollout",
    "ifeval": "pipelinerl_tpu_torch.domains.ifeval.rollouts.generate_ifeval_rollout",
    "logic": "pipelinerl_tpu_torch.domains.logic.rollouts.generate_logic_rollout",
    "deep_research": "pipelinerl_tpu_torch.domains.deep_research.rollouts.generate_research_rollout",
    "miniwob": "pipelinerl_tpu_torch.domains.miniwob.rollouts.generate_miniwob_rollout",
    "chartqa": "pipelinerl_tpu_torch.domains.chartqa.generate_chartqa_rollout",
    "vlm_bandit": "pipelinerl_tpu_torch.domains.vlm_bandit.generate_vlm_bandit_rollout",
}


def resolve(dotted_path: str) -> Callable:
    module_name, _, attr = dotted_path.rpartition(".")
    if not module_name:
        raise ValueError(f"Not a dotted path: {dotted_path!r}")
    module = importlib.import_module(module_name)
    try:
        return getattr(module, attr)
    except AttributeError:
        raise ImportError(f"{module_name!r} has no attribute {attr!r}") from None


def resolve_domain_rollout(domain: str, overrides: dict[str, str] | None = None) -> Callable:
    table = {**DEFAULT_DOMAIN_ROLLOUTS, **(overrides or {})}
    if domain not in table:
        raise KeyError(f"No rollout generator registered for domain {domain!r}")
    return resolve(table[domain])


async def generate_dispatched_rollout(cfg: Any, llm: Any, problem: dict, session: Any):
    """Dispatch by ``problem['domain']``; ``cfg.domain_rollouts`` overrides
    the table."""
    domain = problem.get("domain")
    if not domain:
        raise ValueError("problem has no 'domain' key for dispatch")
    dr = cfg.get("domain_rollouts") if cfg is not None else None
    overrides = {k: v for k, v in dr.items()} if dr else None
    return await resolve_domain_rollout(domain, overrides)(cfg, llm, problem, session)
