"""Core data model shared by the pipeline stages.

Port of the JAX package's ``types.py`` with plain dataclasses in place of
the pydantic models. ``TrainingText`` and ``RolloutResult`` keep the same
fields; ``TrainerBatch`` keeps its static packed ``[1, L]`` numpy layout and
its stream message form (the same JSON, key for key), so either package can
read the other's ``training_data`` stream.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Sequence

import numpy as np

# label mask convention (reference finetune/data.py)
MASKED_TOKEN_ID = -100


@dataclass
class BaseMetrics:
    """Per-rollout scalar metrics every domain reports."""

    reward: float
    success: bool | float
    no_error: bool | float
    no_answer: bool | float

    def model_dump(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


@dataclass
class TrainingText:
    """One trainable (prompt, completion) span with sampler logprobs:
    ``input_ids`` is the exact token sequence the sampler consumed and
    produced, ``labels`` masks the prompt with -100, ``logprobs`` are the
    sampler's per-completion-token logprobs."""

    text: str = ""
    n_predicted: int = 0
    reward: float = 0.0
    logprobs: list[float] = field(default_factory=list)
    ref_logprobs: list[float] = field(default_factory=list)
    input_ids: list[int] = field(default_factory=list)
    labels: list[int] = field(default_factory=list)
    group_id: str | None = None
    finished: bool = False
    finish_reason: str | None = None
    prompt_tokens: int = 0
    output_tokens: int = 0
    # VLM: {"pixel_values", "image_grid_thw"} as the processor extracted them
    visual_features: dict[str, Any] | None = None
    metadata: dict = field(default_factory=dict)


@dataclass
class RolloutResult:
    """Everything a domain returns for one rollout."""

    training_texts: list[TrainingText]
    metrics: BaseMetrics
    latency: float = 0.0
    model_version: int | None = None
    dataset_name: str | None = None
    group_id: str | None = None
    domain: str | None = None


def rollout_has_overflow(training_texts: Sequence[TrainingText]) -> bool:
    """Whether a rollout's turn stopped on the token budget, not at EOS."""
    return any(not t.finished for t in training_texts)


# Per-token float columns carried alongside input_ids through packing
RL_DATA_COLUMNS = (
    "rewards",
    "advantages",
    "ref_logprobs",
    "old_logprobs",
    "group_tokens",
    "num_labels",
    "overflow",
)

_INT_FIELDS = ("input_ids", "labels", "position_ids", "segment_ids")
_FLOAT_FIELDS = RL_DATA_COLUMNS


class TrainerBatch:
    """A packed, fixed-shape training micro-batch: every array field is
    ``[1, L]`` with L the static packed length (``finetune.seq_length``).
    Padding is a last segment with every label masked, so it adds nothing to
    the loss."""

    __slots__ = (*_INT_FIELDS, *_FLOAT_FIELDS, "model_version", "sentinel", "padding",
                 "seq_boundaries", "num_sequences", "visual")

    def __init__(
        self,
        *,
        input_ids,
        labels,
        position_ids,
        segment_ids,
        rewards,
        advantages,
        ref_logprobs,
        old_logprobs,
        group_tokens,
        num_labels,
        overflow,
        model_version: int = 0,
        sentinel: bool = False,
        padding: int = 0,
        seq_boundaries=None,
        num_sequences: int = 0,
        visual: dict | None = None,
    ):
        def as2d(x, dtype):
            arr = np.asarray(x, dtype=dtype)
            return arr[None, :] if arr.ndim == 1 else arr

        for name, value in zip(_INT_FIELDS, (input_ids, labels, position_ids, segment_ids)):
            setattr(self, name, as2d(value, np.int32))
        floats = (rewards, advantages, ref_logprobs, old_logprobs, group_tokens, num_labels, overflow)
        for name, value in zip(_FLOAT_FIELDS, floats):
            setattr(self, name, as2d(value, np.float32))
        self.model_version = int(model_version)
        self.sentinel = bool(sentinel)
        self.padding = int(padding)
        self.seq_boundaries = (
            np.asarray(seq_boundaries, dtype=np.int32) if seq_boundaries is not None else None
        )
        self.num_sequences = int(num_sequences)
        # a VLM row (one unpacked sample): {"pixel_values" [N, patch_dim]
        # f32, "image_grid_thw" [n, 3] i64, "mrope_position_ids" [3, L] i32}
        if visual is not None:
            visual = {
                "pixel_values": np.asarray(visual["pixel_values"], np.float32),
                "image_grid_thw": np.asarray(visual["image_grid_thw"], np.int64).reshape(-1, 3),
                "mrope_position_ids": np.asarray(visual["mrope_position_ids"], np.int32),
            }
        self.visual = visual

    @property
    def length(self) -> int:
        return int(self.input_ids.shape[1])

    def arrays(self) -> dict[str, np.ndarray]:
        return {name: getattr(self, name) for name in _INT_FIELDS + _FLOAT_FIELDS}

    def to_msg(self, arrays: bool = False) -> dict[str, Any]:
        """The ``training_data`` stream message: JSON lists, or numpy arrays
        with ``arrays`` (the binary backend's, as the JAX package writes)."""
        msg: dict[str, Any] = {
            name: getattr(self, name)[0] if arrays else getattr(self, name)[0].tolist()
            for name in _INT_FIELDS + _FLOAT_FIELDS
        }
        msg["model_version"] = self.model_version
        msg["sentinel"] = self.sentinel
        msg["padding"] = self.padding
        msg["num_sequences"] = self.num_sequences
        if self.seq_boundaries is not None:
            msg["seq_boundaries"] = self.seq_boundaries.tolist()
        if self.visual is not None:
            msg["visual"] = dict(self.visual) if arrays else {k: v.tolist() for k, v in self.visual.items()}
        return msg

    @classmethod
    def from_msg(cls, msg: dict[str, Any]) -> "TrainerBatch":
        return cls(
            model_version=msg.get("model_version", 0),
            sentinel=msg.get("sentinel", False),
            padding=msg.get("padding", 0),
            num_sequences=msg.get("num_sequences", 0),
            seq_boundaries=msg.get("seq_boundaries"),
            visual=msg.get("visual"),
            **{name: np.asarray(msg[name]) for name in _INT_FIELDS + _FLOAT_FIELDS},
        )
