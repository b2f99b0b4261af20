"""Domain-weighted problem sampling with adaptive completion-ratio rebalance.

Port of the JAX package's ``domain_sampling.py``: static per-domain weights,
switching to adaptive weights (target ratio over observed completion
ratio, clamped to [0.1, 10]) once 50 completions have been recorded, so the
output stream holds the configured domain mix even when domains complete at
different speeds. On the same ``random.Random`` it draws what JAX's draws.
"""

from __future__ import annotations

import random
from collections import defaultdict
from typing import Mapping

from .domains.registry import resolve

MIN_COMPLETIONS_FOR_ADJUSTMENT = 50
MIN_ADJUSTMENT = 0.1
MAX_ADJUSTMENT = 10.0


class DomainWeightedSampler:
    def __init__(self, samples: list[dict], weights: Mapping[str, float], rng: random.Random | None = None,
                 adaptive: bool = True):
        if not weights:
            raise ValueError("domain_mix cannot be empty")
        self.random = rng or random.Random()
        self.adaptive = adaptive

        by_domain: dict[str, list[dict]] = defaultdict(list)
        for s in samples:
            domain = s.get("domain")
            if not domain:
                raise ValueError("every problem needs a 'domain' field for domain_mix")
            by_domain[str(domain)].append(s)

        for d, w in weights.items():
            if float(w) < 0:
                raise ValueError(f"negative domain weight for {d!r}")
        cleaned = {str(d): float(w) for d, w in weights.items() if float(w) > 0}
        if not cleaned:
            raise ValueError("domain_mix needs at least one positive weight")
        missing = set(by_domain) - {str(d) for d in weights}
        if missing:
            raise ValueError(f"domain_mix missing weights for: {sorted(missing)}")
        unused = set(cleaned) - set(by_domain)
        if unused:
            raise ValueError(f"domain_mix names absent domains: {sorted(unused)}")

        self.samples_by_domain = dict(by_domain)
        self.domains = list(cleaned)
        self.base_weights = cleaned
        total = sum(cleaned.values())
        self.target_ratios = {d: w / total for d, w in cleaned.items()}
        self.completion_counts = {d: 0 for d in self.domains}
        self.total_completions = 0

    def record_completion(self, domain: str) -> None:
        if domain in self.completion_counts:
            self.completion_counts[domain] += 1
            self.total_completions += 1

    def _weights_now(self) -> dict[str, float]:
        if not self.adaptive or self.total_completions < MIN_COMPLETIONS_FOR_ADJUSTMENT:
            return self.base_weights
        out = {}
        for d in self.domains:
            current = self.completion_counts[d] / self.total_completions
            adj = MAX_ADJUSTMENT
            if current > 0:
                adj = min(MAX_ADJUSTMENT, max(MIN_ADJUSTMENT, self.target_ratios[d] / current))
            out[d] = self.base_weights[d] * adj
        return out

    def _pick_domain(self) -> str:
        weights = self._weights_now()
        r = self.random.random() * sum(weights.values())
        acc = 0.0
        for d in self.domains:
            acc += weights[d]
            if r < acc:
                return d
        return self.domains[-1]

    def sample(self) -> dict:
        return self.random.choice(self.samples_by_domain[self._pick_domain()])


# the JAX package's loader table, renamed
_LOADERS = {
    "math": "pipelinerl_tpu_torch.domains.math.load_datasets.load_datasets",
    "guessing": "pipelinerl_tpu_torch.domains.guessing.load_problems",
    "counting": "pipelinerl_tpu_torch.domains.counting.load_problems",
    "bandit": "pipelinerl_tpu_torch.domains.bandit.load_problems",
    "chartqa": "pipelinerl_tpu_torch.domains.chartqa.load_datasets",
}


def load_multidomain(dataset_names: list[str]) -> list[dict]:
    """``domain::dataset`` names: each routes to its domain's loader, and the
    problems keep their domain tag for dispatch."""
    grouped: dict[str, list[str]] = defaultdict(list)
    for name in dataset_names:
        if "::" not in name:
            raise ValueError(f"multidomain dataset name must be domain::dataset, got {name!r}")
        domain, _, dataset = name.partition("::")
        if domain not in _LOADERS:
            raise ValueError(f"unknown domain {domain!r} in {name!r}")
        grouped[domain].append(dataset)
    problems: list[dict] = []
    for domain, names in grouped.items():
        loaded = resolve(_LOADERS[domain])(names)
        for p in loaded:
            p.setdefault("domain", domain)
        problems.extend(loaded)
    return problems
