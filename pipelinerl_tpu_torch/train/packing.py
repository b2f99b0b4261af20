"""Sequence packing into fixed-shape trainer batches.

Port of the JAX package's ``train/packing.py``. Every pack is padded to the static ``seq_length``
with a padding segment (EOS tokens, labels -100, num_labels and
group_tokens 1), so every micro-batch has one shape.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np

from ..types import MASKED_TOKEN_ID, RL_DATA_COLUMNS, TrainerBatch


def pack_samples(
    samples: Sequence[dict[str, Any]],
    seq_length: int,
    eos_token_id: int,
    sentinel: bool = False,
) -> TrainerBatch:
    """Pack samples (dicts with input_ids/labels and the RL columns) into one
    ``[1, seq_length]`` TrainerBatch."""
    total = sum(len(s["input_ids"]) for s in samples)
    if total > seq_length:
        raise ValueError(f"samples total {total} exceeds seq_length {seq_length}")
    pad = seq_length - total

    input_ids = np.full(seq_length, eos_token_id, dtype=np.int32)
    labels = np.full(seq_length, MASKED_TOKEN_ID, dtype=np.int32)
    position_ids = np.zeros(seq_length, dtype=np.int32)
    segment_ids = np.zeros(seq_length, dtype=np.int32)
    floats = {name: np.zeros(seq_length, dtype=np.float32) for name in RL_DATA_COLUMNS}

    boundaries = [0]
    offset = 0
    for i, s in enumerate(samples):
        n = len(s["input_ids"])
        sl = slice(offset, offset + n)
        input_ids[sl] = s["input_ids"]
        seq_labels = np.asarray(s["labels"], dtype=np.int32)
        if n > 0:
            # a segment's first token cannot be predicted from inside it
            seq_labels = seq_labels.copy()
            seq_labels[0] = MASKED_TOKEN_ID
        labels[sl] = seq_labels
        position_ids[sl] = np.arange(n)
        segment_ids[sl] = i
        for name in RL_DATA_COLUMNS:
            floats[name][sl] = s[name]
        offset += n
        boundaries.append(offset)

    if pad > 0:
        sl = slice(offset, seq_length)
        position_ids[sl] = np.arange(pad)
        segment_ids[sl] = len(samples)
        floats["group_tokens"][sl] = 1.0
        floats["num_labels"][sl] = 1.0
        boundaries.append(seq_length)

    return TrainerBatch(
        input_ids=input_ids,
        labels=labels,
        position_ids=position_ids,
        segment_ids=segment_ids,
        model_version=min((s.get("model_version", 0) for s in samples), default=0),
        sentinel=sentinel,
        padding=pad,
        seq_boundaries=np.asarray(boundaries, dtype=np.int32),
        num_sequences=len(samples),
        **floats,
    )


def pack_visual_sample(
    sample: dict[str, Any],
    seq_length: int,
    eos_token_id: int,
    image_token_id: int,
    spatial_merge_size: int = 2,
) -> TrainerBatch:
    """One multimodal sample as its own ``[1, seq_length]`` batch (VLM rows
    are never packed with others), with its pixel features and mrope
    position rows (``models/mrope.py``) for the trainer's spliced forward.
    The padding continues the rows from the prompt's largest position."""
    from ..models.mrope import mrope_positions

    batch = pack_samples([sample], seq_length, eos_token_id)
    vis = sample["visual_features"]
    grid = np.asarray(vis["image_grid_thw"], np.int64).reshape(-1, 3)
    n = len(sample["input_ids"])
    pos3, _ = mrope_positions(sample["input_ids"], grid, image_token_id, spatial_merge_size)
    pos_full = np.zeros((3, seq_length), np.int32)
    pos_full[:, :n] = pos3
    pos_full[:, n:] = pos3.max() + 1 + np.arange(seq_length - n, dtype=np.int32)
    batch.visual = {
        "pixel_values": np.asarray(vis["pixel_values"], np.float32),
        "image_grid_thw": grid,
        "mrope_position_ids": pos_full,
    }
    return batch


def make_sentinel_batch(seq_length: int, eos_token_id: int, model_version: int = 0) -> TrainerBatch:
    """A loss-free full-length batch that evens out gradient-accumulation
    passes across data-parallel ranks."""
    batch = pack_samples([], seq_length, eos_token_id, sentinel=True)
    batch.model_version = model_version
    return batch


def greedy_pack(samples: Sequence[dict[str, Any]], seq_length: int) -> list[list[dict[str, Any]]]:
    """Greedy packing in arrival order (freshness first)."""
    packs: list[list[dict[str, Any]]] = []
    current: list[dict[str, Any]] = []
    used = 0
    for s in samples:
        n = len(s["input_ids"])
        if n > seq_length:
            raise ValueError(f"sample of {n} tokens exceeds seq_length {seq_length}")
        if used + n > seq_length:
            packs.append(current)
            current, used = [], 0
        current.append(s)
        used += n
    if current:
        packs.append(current)
    return packs
