"""GRPO leave-one-out advantages and per-token RL field population.

Port of the JAX package's ``train/advantages.py`` (host-side Python):

- advantage of rollout r in group g at step s: ``reward - LOO_mean``, over
  ``std + 1e-4`` with ``divide_advantage_by_std``, where LOO_mean is the mean
  step reward of the other rollouts in (g, s) and std the sample std
  (ddof 1) over all of them (0 for a single rollout);
- ``group_tokens``: mean total token count per rollout in the group;
- ``overflow``: 1.0 when the sequence hit the length limit;
- ``num_labels``: number of unmasked label positions, per token.
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import Any, Sequence

from ..types import MASKED_TOKEN_ID, TrainingText


def prepare_rl_fields(sample: dict[str, Any]) -> dict[str, Any]:
    """Expand per-sequence reward and logprobs into per-token columns."""
    labels = sample["labels"]
    n = len(labels)
    old_logprobs = sample.pop("logprobs")
    ref_logprobs = sample.pop("ref_logprobs", []) or []
    n_target = sum(1 for l in labels if l != MASKED_TOKEN_ID)
    if len(old_logprobs) != n_target:
        raise ValueError(f"Got {len(old_logprobs)} sampler logprobs for {n_target} target tokens")
    if ref_logprobs and len(ref_logprobs) != n_target:
        raise ValueError(f"Got {len(ref_logprobs)} ref logprobs for {n_target} target tokens")
    sample["rewards"] = [float(sample["reward"])] * n
    sample["advantages"] = [0.0] * n
    sample["old_logprobs"] = [0.0] * (n - len(old_logprobs)) + [float(x) for x in old_logprobs]
    sample["ref_logprobs"] = (
        [0.0] * (n - len(ref_logprobs)) + [float(x) for x in ref_logprobs] if ref_logprobs else [0.0] * n
    )
    sample["overflow"] = [0.0] * n
    sample["group_tokens"] = [0.0] * n
    sample["num_labels"] = [1.0 if l != MASKED_TOKEN_ID else 0.0 for l in labels]
    return sample


def training_text_to_sample(
    text: TrainingText, model_version: int, rollout_index: int = 0, step_index: int = 0
) -> dict[str, Any]:
    """TrainingText → stream sample dict carrying every RL column."""
    sample = {
        "input_ids": list(text.input_ids),
        "labels": list(text.labels),
        "reward": float(text.reward),
        "logprobs": list(text.logprobs),
        "ref_logprobs": list(text.ref_logprobs),
        "group_id": text.group_id,
        "rollout_index": rollout_index,
        "step_index": step_index,
        "model_version": model_version,
        "finished": bool(text.finished),
        "finish_reason": text.finish_reason,
    }
    if text.visual_features is not None:
        # VLM: the pixel features ride with the sample to pack_visual_sample
        sample["visual_features"] = text.visual_features
    return prepare_rl_fields(sample)


def _sequence_overflow(sample: dict[str, Any], eos_token_id: int) -> float:
    reason = sample.get("finish_reason")
    if isinstance(reason, str):
        reason = reason.strip().lower()
        if reason == "length":
            return 1.0
        if reason in ("stop", "content_filter"):
            return 0.0
    if sample.get("finished"):
        return 0.0
    return 0.0 if eos_token_id in sample["input_ids"] else 1.0


def populate_rl_data(
    samples: list[dict[str, Any]], eos_token_id: int, divide_advantage_by_std: bool = False
) -> list[dict[str, Any]]:
    """Fill advantages, group_tokens, overflow and num_labels in place.
    ``samples`` carry group_id, rollout_index, step_index, the per-token
    ``rewards`` of ``prepare_rl_fields``, input_ids and labels."""
    rollout_tokens: dict[tuple, int] = defaultdict(int)
    step_rewards: dict[tuple, list[float]] = defaultdict(list)
    for s in samples:
        g, r, st = s["group_id"], s["rollout_index"], s["step_index"]
        rollout_tokens[(g, r)] += len(s["input_ids"])
        step_rewards[(g, st)].append(float(s["rewards"][0]))

    group_rollouts: dict[Any, list[int]] = defaultdict(list)
    for (g, _), tokens in rollout_tokens.items():
        group_rollouts[g].append(tokens)
    group_token_means = {g: sum(c) / len(c) for g, c in group_rollouts.items()}

    stats: dict[tuple, tuple[float, int, float]] = {}
    for key, rs in step_rewards.items():
        n, total = len(rs), sum(rs)
        if n > 1:
            mean = total / n
            std = math.sqrt(sum((x - mean) ** 2 for x in rs) / (n - 1))
        else:
            std = 0.0
        stats[key] = (total, n, std)

    for s in samples:
        g, st = s["group_id"], s["step_index"]
        total, n, std = stats[(g, st)]
        current = float(s["rewards"][0])
        loo_mean = (total - current) / (n - 1) if n > 1 else current
        denom = (std + 1e-4) if divide_advantage_by_std else 1.0
        s["advantages"] = [(float(r) - loo_mean) / denom for r in s["rewards"]]
        length = len(s["input_ids"])
        s["group_tokens"] = [group_token_means[g]] * length
        s["overflow"] = [_sequence_overflow(s, eos_token_id)] * length
        n_labels = sum(1 for l in s["labels"] if l != MASKED_TOKEN_ID)
        s["num_labels"] = [float(n_labels)] * length
    return samples


def group_advantages_all_zero(group_samples: Sequence[dict[str, Any]], tol: float = 1e-9) -> bool:
    """True when every advantage in the group is ~0."""
    return all(abs(a) < tol for s in group_samples for a in s.get("advantages", []))
