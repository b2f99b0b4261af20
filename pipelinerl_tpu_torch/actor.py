"""Actor: schedules grouped rollouts against inference engines with lag
control, stamps samples with weight versions, publishes stats.

Port of the JAX package's ``actor.py`` (``ActorLoop``, ``ActorStats``) as
the same single-process asyncio scheduler, with domain-weighted sampling
(``domain_mix``) and the difficulty-aware length penalty for training
rollouts, and the eval loop (``is_training=False``: ``test_attempts``
rollouts a problem on the ``actor_test`` and ``stats_test`` topics, a
snapshot at its end) that eval interleaving runs while
``is_scheduling_paused`` holds the training loop's submissions.

- each problem spawns a group of ``attempts`` rollouts, written to the
  ``actor`` stream when complete, shuffled;
- least-busy engine selection under a per-engine in-flight cap;
- lag control: with ``finetune.max_lag`` set, the submit budget in groups
  is ``ceil(max_lag / attempts) + ceil(update_size / attempts) +
  version // attempts``;
- samples carry the version the engine generated them under; an aborted or
  empty completion is retried, and a group that stays so is dropped;
- where ``cfg.environment`` names environment servers, one client session
  (``utils/http_json.JsonSession``) lives as long as ``run`` and every
  rollout gets it, so the domains reach their servers. (The JAX package
  hands every rollout ``None``, and its domains then never reach the
  servers its launcher starts.)
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import logging
import math
import random
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Callable, Sequence

from .config import Config
from .domain_sampling import DomainWeightedSampler
from .domains.math.rollouts import length_penalty
from .domains.registry import resolve
from .domains.servers import environment_servers
from .inference.client import BaseLLM
from .state import TrainerState
from .streams import SingleStreamSpec, StreamWriter
from .train.advantages import training_text_to_sample
from .types import RolloutResult
from .utils import SlidingWindowAggregator, always_or_never_success_stats, calculate_stats
from .utils.http_json import JsonSession

logger = logging.getLogger(__name__)


def _has_degenerate_text(result: RolloutResult) -> bool:
    """An aborted or empty completion must not become a training sample."""
    return any(t.finish_reason == "abort" or t.output_tokens == 0 for t in result.training_texts)


@dataclass
class ActorStats:
    groups_completed: int = 0
    rollouts_completed: int = 0
    samples_written: int = 0
    output_tokens: int = 0
    aborted_rollout_retries: int = 0
    dropped_degenerate_groups: int = 0
    metrics: dict[str, list[float]] = field(default_factory=dict)
    # per-dataset and per-domain windowed aggregates
    grouped_metrics: dict[str, dict[str, list[float]]] = field(default_factory=dict)
    # per-problem success history (cumulative): always/sometimes/never
    problem_success: dict[str, list[float]] = field(default_factory=dict)
    version_lags: list[float] = field(default_factory=list)
    # full-run success history, never drained by snapshot
    success_history: list[float] = field(default_factory=list)

    def record_rollout(self, result: RolloutResult, problem_key: str | None = None) -> None:
        self.rollouts_completed += 1
        group_keys = []
        if result.dataset_name:
            group_keys.append(f"dataset/{result.dataset_name}")
        if result.domain:
            group_keys.append(f"domain/{result.domain}")
        for name, value in result.metrics.model_dump().items():
            if isinstance(value, bool):
                value = float(value)
            if isinstance(value, (int, float)):
                self.metrics.setdefault(name, []).append(float(value))
                for gk in group_keys:
                    self.grouped_metrics.setdefault(gk, {}).setdefault(name, []).append(float(value))
        if problem_key is not None:
            self.problem_success.setdefault(problem_key, []).append(float(result.metrics.success))
        self.success_history.append(float(result.metrics.success))

    def snapshot(self) -> dict[str, Any]:
        """Windowed stats: the metric buffers drain, so each snapshot covers
        the rollouts since the previous one."""
        out: dict[str, Any] = {
            "groups_completed": self.groups_completed,
            "rollouts_completed": self.rollouts_completed,
            "samples_written": self.samples_written,
            "output_tokens": self.output_tokens,
            "aborted_rollout_retries": self.aborted_rollout_retries,
            "dropped_degenerate_groups": self.dropped_degenerate_groups,
        }
        for name, values in self.metrics.items():
            for stat, val in calculate_stats(values).items():
                out[f"{name}_{stat}"] = val
        self.metrics = {}
        for gk, metrics in self.grouped_metrics.items():
            for name, values in metrics.items():
                if values:
                    out[f"{gk}/{name}_mean"] = sum(values) / len(values)
                    out[f"{gk}/{name}_count"] = len(values)
        self.grouped_metrics = {}
        out.update(always_or_never_success_stats(self.problem_success))
        if self.success_history:
            tail = self.success_history[-max(1, len(self.success_history) // 3) :]
            out["success_tail_mean"] = sum(tail) / len(tail)
        if self.version_lags:
            for stat, val in calculate_stats(self.version_lags).items():
                out[f"model_version_lag_{stat}"] = val
            self.version_lags = []
        return out


class ActorLoop:
    def __init__(
        self,
        cfg: Config,
        llms: Sequence[BaseLLM],
        problems: Sequence[dict],
        trainer_state: TrainerState,
        exp_path: str,
        rollout_policy: Callable,
        is_training: bool = True,
    ):
        self.cfg = cfg
        self.llms = list(llms)
        self.problems = list(problems)
        self.trainer_state = trainer_state
        self.exp_path = exp_path
        self.rollout_policy = rollout_policy
        self.is_training = is_training
        self.attempts = int(cfg.attempts) if is_training else int(cfg.get("test_attempts", 1))
        self.stats = ActorStats()
        self.tokens_window = SlidingWindowAggregator(int(cfg.actor.get("throughput_window_size", 50)))
        self._active_per_llm = [0] * len(self.llms)
        self._rng = random.Random(int(cfg.get("seed", 0)))
        # set by eval interleaving: no new training group is submitted
        self.is_scheduling_paused = False
        # the environment servers' client session, open during run()
        self._session: JsonSession | None = None
        self.data_spec = SingleStreamSpec(exp_path=exp_path, topic="actor" if is_training else "actor_test")
        self.stats_spec = SingleStreamSpec(exp_path=exp_path, topic="stats" if is_training else "stats_test")

    def _lag_budget(self, trained_version: int) -> float:
        """Absolute submit budget in groups at a trainer version (=
        cumulative trained samples): submitted x attempts may run at most
        max_lag plus one update window ahead of training."""
        max_lag = self.cfg.finetune.get("max_lag")
        if not self.is_training or max_lag is None:
            return math.inf
        samples_per_step = int(self.cfg.finetune.samples_per_step)
        update_interval = int(self.cfg.finetune.get("weight_update_interval", 1))
        total_update_size = math.ceil(update_interval / samples_per_step) * samples_per_step
        return (
            math.ceil(int(max_lag) / self.attempts)
            + math.ceil(total_update_size / self.attempts)
            + int(trained_version) // self.attempts
        )

    def _pick_llm(self) -> int | None:
        cap = int(self.cfg.actor.get("llm_max_rollouts", 64))
        best, best_active = None, cap
        for i, active in enumerate(self._active_per_llm):
            if active < best_active:
                best, best_active = i, active
        return best

    async def _run_one_rollout(self, problem: dict, group_id: str, rollout_idx: int) -> RolloutResult:
        max_retries = int(self.cfg.actor.get("max_rollout_retries", 2))
        attempt = 0
        while True:
            llm_idx = self._pick_llm()
            while llm_idx is None:
                await asyncio.sleep(0.01)
                llm_idx = self._pick_llm()
            self._active_per_llm[llm_idx] += 1
            try:
                result = await self.rollout_policy(self.cfg, self.llms[llm_idx], problem, self._session)
                if _has_degenerate_text(result):
                    attempt += 1
                    if max_retries < 0 or attempt <= max_retries:
                        self.stats.aborted_rollout_retries += 1
                        logger.warning("Rollout produced an aborted/empty completion (attempt %d/%d); retrying",
                                       attempt, max_retries)
                        continue
                    logger.warning("Rollout still degenerate after %d attempts; its group will be dropped", attempt)
                break
            except Exception:
                attempt += 1
                if max_retries >= 0 and attempt > max_retries:
                    raise
                logger.exception("Rollout failed (attempt %d/%d); retrying", attempt, max_retries)
                await asyncio.sleep(min(2.0**attempt * 0.1, 5.0))
            finally:
                self._active_per_llm[llm_idx] -= 1
        result.group_id = group_id
        if result.model_version is None:
            # the version the engine generated under; the trainer's current
            # version only for texts that carry none
            versions = [
                t.metadata["model_version"] for t in result.training_texts if t.metadata.get("model_version") is not None
            ]
            result.model_version = min(versions) if versions else (self.trainer_state.propagated_weight_version or 0)
        return result

    async def _run_group(self, problem: dict) -> list[RolloutResult]:
        group_id = str(uuid.uuid4())
        tasks = [asyncio.create_task(self._run_one_rollout(problem, group_id, i)) for i in range(self.attempts)]
        try:
            return await asyncio.gather(*tasks)
        except Exception:
            for t in tasks:
                t.cancel()
            raise

    def _apply_difficulty_aware_penalty(self, results: list[RolloutResult]) -> None:
        """Rescale the overlong length penalty by the group's solve rate:
        successful rollouts keep ``solve_rate ** gamma`` of theirs, failed
        ones ``failure_scale``; a text that hit ``max_tokens`` unfinished
        always keeps the full penalty."""
        dap = self.cfg.actor.get("difficulty_aware_penalty")
        buffer_tokens = int(self.cfg.get("rewards", Config({})).get("buffer_tokens", 0) or 0)
        max_tokens = self.cfg.llm.parameters.get("max_tokens")
        if not self.is_training or not dap or not dap.get("enabled", False) or buffer_tokens <= 0 \
                or max_tokens is None:
            return
        gamma = float(dap.get("gamma", 1.0))
        failure_scale = float(dap.get("failure_scale", 1.0))
        solve_rate = sum(float(r.metrics.success) for r in results) / len(results)
        success_scale = solve_rate**gamma
        for r in results:
            rollout_scale = success_scale if r.metrics.success else failure_scale
            delta_total = 0.0
            for text in r.training_texts:
                scale = 1.0 if text.output_tokens >= max_tokens and not text.finished else rollout_scale
                original = length_penalty(max_tokens, text.output_tokens, buffer_tokens)
                delta = original * scale - original
                text.reward += delta
                delta_total += delta
            r.metrics.reward += delta_total

    def _write_group(self, writer: StreamWriter, results: list[RolloutResult]) -> None:
        entries = [(r, ri, si, t) for ri, r in enumerate(results) for si, t in enumerate(r.training_texts)]
        self._rng.shuffle(entries)
        samples = []
        for result, rollout_idx, step_idx, text in entries:
            text.group_id = result.group_id
            sample = training_text_to_sample(
                text, model_version=result.model_version or 0, rollout_index=rollout_idx, step_index=step_idx
            )
            sample["dataset_name"] = result.dataset_name
            sample["domain"] = result.domain
            samples.append(sample)
            self.stats.output_tokens += text.output_tokens
        writer.write(
            {
                "group_id": results[0].group_id,
                "model_version": min(r.model_version or 0 for r in results),
                "samples": samples,
            }
        )
        self.stats.samples_written += len(samples)
        self.stats.groups_completed += 1
        self.tokens_window.update(time.monotonic(), sum(e[3].output_tokens for e in entries))

    async def run(self, total_groups: int | None = None) -> ActorStats:
        """Schedule groups until ``total_groups`` complete (or the trainer is
        done), within the lag budget, with the environment servers' session
        open where ``cfg.environment`` names servers."""
        session = JsonSession() if environment_servers(self.cfg) else contextlib.nullcontext()
        async with session as self._session:
            try:
                return await self._run(total_groups)
            finally:
                self._session = None

    async def _run(self, total_groups: int | None) -> ActorStats:
        submitted = completed = 0
        domain_mix = self.cfg.get("domain_mix")
        sampler = None
        if domain_mix and self.is_training:
            sampler = DomainWeightedSampler(self.problems, dict(domain_mix.items()), rng=self._rng,
                                            adaptive=bool(self.cfg.get("adaptive_domain_sampling", True)))
            problem_iter = iter(self._sampled_stream(sampler, total_groups))
        else:
            problem_iter = iter(self._problem_stream(total_groups))
        in_flight: set[asyncio.Task] = set()
        max_parallel = int(self.cfg.actor.get("max_parallel_groups", 16))
        publish_every = int(self.cfg.actor.get("publish_stats_every_n_groups", 8))

        with StreamWriter(self.data_spec) as writer, StreamWriter(self.stats_spec) as stats_writer:
            exhausted = False
            while not exhausted or in_flight:
                can_submit = self._lag_budget(self.trainer_state.propagated_weight_version or 0)
                while (
                    not exhausted
                    and not self.is_scheduling_paused
                    and len(in_flight) < max_parallel
                    and submitted < can_submit
                ):
                    try:
                        problem = next(problem_iter)
                    except StopIteration:
                        exhausted = True
                        break
                    task = asyncio.create_task(self._run_group(problem))
                    task.problem = problem  # for per-problem success stats
                    in_flight.add(task)
                    submitted += 1
                if not in_flight:
                    if self.trainer_state.training_done:
                        break
                    await asyncio.sleep(0.01)
                    continue
                done, in_flight = await asyncio.wait(in_flight, return_when=asyncio.FIRST_COMPLETED, timeout=0.5)
                for task in done:
                    results = task.result()
                    completed += 1
                    if any(_has_degenerate_text(r) for r in results):
                        # LOO advantages need every attempt: drop the group
                        self.stats.dropped_degenerate_groups += 1
                        continue
                    if sampler is not None:
                        for r in results:
                            if r.domain:
                                sampler.record_completion(r.domain)
                    self._apply_difficulty_aware_penalty(results)
                    problem_key = json.dumps(task.problem, sort_keys=True, default=str)[:256]
                    current_version = self.trainer_state.propagated_weight_version or 0
                    for r in results:
                        self.stats.record_rollout(r, problem_key)
                        self.stats.version_lags.append(float(current_version - (r.model_version or 0)))
                    self._write_group(writer, results)
                    if completed % publish_every == 0:
                        snap = self.stats.snapshot()
                        snap["output_tokens_per_second"] = self.tokens_window.rate_per_sec()
                        stats_writer.write(snap)
                if self.trainer_state.training_done:
                    for task in in_flight:
                        task.cancel()
                    break
            # an eval is shorter than publish_every groups: its snapshot goes
            # out at its end (a training loop's closing snapshot is the
            # caller's)
            if not self.is_training:
                snap = self.stats.snapshot()
                snap["output_tokens_per_second"] = self.tokens_window.rate_per_sec()
                stats_writer.write(snap)
        return self.stats

    def _sampled_stream(self, sampler: DomainWeightedSampler, total_groups: int | None):
        count = 0
        while total_groups is None or count < total_groups:
            yield sampler.sample()
            count += 1

    def _problem_stream(self, total_groups: int | None):
        """Cycle the problems until ``total_groups``, reshuffled each epoch."""
        rng = random.Random(self.cfg.get("seed", 0))
        epoch_problems = list(self.problems)
        count = 0
        while True:
            for problem in epoch_problems:
                if total_groups is not None and count >= total_groups:
                    return
                yield problem
                count += 1
            if not epoch_problems:
                return
            epoch_problems = list(self.problems)
            rng.shuffle(epoch_problems)


def load_test_problems(cfg: Config) -> list[dict]:
    """The eval problems (``test_dataset_names``, cut to ``test_subset``),
    or none when ``eval_every_n_versions`` is off."""
    if not int(cfg.get("eval_every_n_versions", 0) or 0):
        return []
    problems = resolve(cfg.dataset_loader)(list(cfg.get("test_dataset_names", [])))
    return problems[: int(cfg.test_subset)] if cfg.get("test_subset") else problems


async def run_with_evals(train_loop: ActorLoop, test_llms: Sequence[BaseLLM], test_problems: Sequence[dict],
                         total_groups: int | None = None, poll_s: float = 0.2) -> tuple[ActorStats, list[dict]]:
    """Run ``train_loop``; every ``eval_every_n_versions`` weight versions,
    pause its submissions and run ``test_problems`` on ``test_llms``
    through an eval ``ActorLoop``. Returns the training loop's stats and,
    per eval, the version it ran at and the groups and rollouts it
    completed."""
    cfg, state = train_loop.cfg, train_loop.trainer_state
    eval_every = int(cfg.get("eval_every_n_versions", 0) or 0)
    evals: list[dict] = []

    async def watcher() -> None:
        last_eval_version = 0
        while not state.training_done:
            await asyncio.sleep(poll_s)
            version = state.propagated_weight_version or 0
            if version - last_eval_version < eval_every:
                continue
            last_eval_version = version
            train_loop.is_scheduling_paused = True
            logger.info("Starting eval at version %d", version)
            eval_loop = ActorLoop(cfg, test_llms, test_problems, state, train_loop.exp_path,
                                  train_loop.rollout_policy, is_training=False)
            try:
                stats = await eval_loop.run(total_groups=len(test_problems))
            finally:
                train_loop.is_scheduling_paused = False
            evals.append({"version": version, "groups": stats.groups_completed,
                          "rollouts": stats.rollouts_completed})
            logger.info("Eval at version %d done", version)

    task = asyncio.create_task(watcher()) if eval_every and test_problems else None
    try:
        return await train_loop.run(total_groups=total_groups), evals
    finally:
        if task is not None:
            # once training is done an eval under way stops at its next
            # check and writes its snapshot; otherwise the watcher goes
            if not state.training_done:
                task.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await task
