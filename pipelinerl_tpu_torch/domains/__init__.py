"""Task domains: ``load_problems(dataset_names)`` and
``async generate_rollout(cfg, llm, problem, session)`` per domain, resolved
by dotted path. The port has the bandit domain (the RL loop's oracle), the
hermetic counting and guessing domains, math, logic, ifeval and fn_calling
on their synthetic sets, and tir, coding, deep_research and miniwob on
their hermetic sets and in-process environments."""

from .registry import resolve, resolve_domain_rollout  # noqa: F401
