"""Preprocessor: groups → advantages → packing → the partitioned
``training_data`` stream, with backpressure.

Port of the JAX package's ``preprocess.py``; a visual sample becomes a row
of its own (``pack_visual_sample``). With a ``ref_score_fn`` (the KL
reference engine's ``score_tokens``) each sample gets its reference-policy
logprobs. Packs are padded to the static
``finetune.seq_length``; the ring buffer, zero-advantage filtering, sentinel
equalization and ``samples_processed`` backpressure keep the JAX package's
semantics.
"""

from __future__ import annotations

import logging
import time
from collections import deque
from typing import Callable, Sequence

from .config import Config
from .state import TrainerState
from .streams import RangeStreamWriter, SingleStreamSpec, StreamRangeSpec, StreamReader, get_streams_backend
from .train.advantages import group_advantages_all_zero, populate_rl_data
from .train.packing import make_sentinel_batch, pack_samples, pack_visual_sample
from .types import MASKED_TOKEN_ID

logger = logging.getLogger(__name__)


class Preprocessor:
    def __init__(
        self,
        cfg: Config,
        exp_path: str,
        trainer_state: TrainerState,
        eos_token_id: int,
        num_trainers: int = 1,
        ref_score_fn: Callable[[Sequence[int]], list[float]] | None = None,
        input_topic: str = "actor",
        output_topic: str = "training_data",
        image_token_id: int | None = None,
        spatial_merge_size: int = 2,
    ):
        self.cfg = cfg
        self.exp_path = exp_path
        self.trainer_state = trainer_state
        self.eos_token_id = eos_token_id
        self.num_trainers = num_trainers
        self.ref_score_fn = ref_score_fn
        self.input_spec = SingleStreamSpec(exp_path=exp_path, topic=input_topic)
        self.output_spec = StreamRangeSpec(exp_path=exp_path, topic=output_topic, partitions=tuple(range(num_trainers)))
        self.seq_length = int(cfg.finetune.seq_length)
        # VLM: the mrope rows of a visual sample are made at packing time
        self.image_token_id = image_token_id
        self.spatial_merge_size = spatial_merge_size
        ring_size = int(cfg.preprocess.get("ring_buffer_size", 128))
        self.ring: deque[dict] = deque(maxlen=ring_size if cfg.get("pop_old_data", True) else None)
        self.published_samples = 0
        self.dropped_old_samples = 0
        self.filtered_zero_adv_groups = 0
        self._stop = False

    def stop(self) -> None:
        self._stop = True

    def process_group(self, group_msg: dict) -> list[dict]:
        """Reference logprobs (with a ``ref_score_fn``) and advantages for
        one group; returns the sample dicts to pack."""
        samples = group_msg["samples"]
        attempts = int(self.cfg.attempts)
        rollouts = {s["rollout_index"] for s in samples}
        if len(rollouts) != attempts:
            raise ValueError(
                f"Group {group_msg.get('group_id')} has {len(rollouts)} rollouts, expected {attempts}"
            )
        if self.ref_score_fn is not None:
            for s in samples:
                # scored[i] is the logprob of token i + 1: shift onto the
                # labels, 0 where a label is masked
                ref = [0.0] + list(self.ref_score_fn(s["input_ids"]))
                s["ref_logprobs"] = [r if label != MASKED_TOKEN_ID else 0.0 for r, label in zip(ref, s["labels"])]
        rl = self.cfg.finetune.rl
        populate_rl_data(
            samples, eos_token_id=self.eos_token_id,
            divide_advantage_by_std=bool(rl.get("divide_advantage_by_std", False)),
        )
        if bool(rl.get("filter_zero_advantage_groups", False)) and group_advantages_all_zero(samples):
            self.filtered_zero_adv_groups += 1
            return []
        kept = []
        for s in samples:
            if len(s["input_ids"]) > self.seq_length:
                logger.warning("Dropping sample of %d tokens > seq_length %d", len(s["input_ids"]), self.seq_length)
                continue
            kept.append(s)
        return kept

    def _backpressure_limit(self) -> int:
        max_ready = int(self.cfg.preprocess.get("max_ready_samples_per_lead", 64))
        return self.trainer_state.samples_processed + max_ready * self.num_trainers

    def run(self, max_groups: int | None = None) -> None:
        """Tail the actor stream until stopped (or ``max_groups``), packing
        into the training_data partitions with sentinel equalization."""
        reader = StreamReader(self.input_spec, poll_interval=0.02)
        writer = RangeStreamWriter(self.output_spec)
        groups_done = 0
        try:
            while not self._stop:
                got_any = False
                for msg in reader.read_available(max_messages=64):
                    got_any = True
                    for s in self.process_group(msg):
                        if self.ring.maxlen is not None and len(self.ring) == self.ring.maxlen:
                            self.dropped_old_samples += 1
                        self.ring.append(s)
                    groups_done += 1
                    if max_groups is not None and groups_done >= max_groups:
                        self._stop = True
                        break
                # backpressure: do not run ahead of the trainer
                emitted = False
                while self.ring and self.published_samples < self._backpressure_limit():
                    self._emit_packs(writer)
                    emitted = True
                if self.trainer_state.training_done:
                    break
                if not got_any and not emitted:
                    time.sleep(0.02)
            while self.ring:
                self._emit_packs(writer)
        finally:
            writer.close()
            reader.stop()

    def _emit_packs(self, writer: RangeStreamWriter) -> None:
        """One fixed-shape batch per trainer partition from the ring's head,
        sentinels filling in, so every lead sees the same number of passes."""
        as_arrays = get_streams_backend() == "binary"
        for partition in range(self.num_trainers):
            batch = self._next_batch()
            writer.write(batch.to_msg(arrays=as_arrays), partition=partition)
            self.published_samples += batch.num_sequences

    def _next_batch(self):
        chosen: list[dict] = []
        used = 0
        while self.ring:
            head = self.ring[0]
            if head.get("visual_features"):
                if chosen:
                    break  # the text pack goes first; the visual row is next
                if self.image_token_id is None:
                    raise ValueError("multimodal sample but the preprocessor has no image_token_id")
                return pack_visual_sample(self.ring.popleft(), self.seq_length, self.eos_token_id,
                                          self.image_token_id, self.spatial_merge_size)
            n = len(head["input_ids"])
            if used + n > self.seq_length:
                break
            chosen.append(self.ring.popleft())
            used += n
        if not chosen:
            return make_sentinel_batch(self.seq_length, self.eos_token_id)
        return pack_samples(chosen, self.seq_length, self.eos_token_id)
