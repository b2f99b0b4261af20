"""Task domains: ``load_problems(dataset_names)`` and
``async generate_rollout(cfg, llm, problem, session)`` per domain, resolved
by dotted path. The port has the bandit domain (the RL loop's oracle) and
the hermetic counting and guessing domains."""

from .registry import resolve, resolve_domain_rollout  # noqa: F401
