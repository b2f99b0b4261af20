"""Visual processors: OpenAI-style multimodal messages to (prompt token ids
with image placeholders, the image features).

Port of the JAX package's ``inference/processor.py``. One processor call
gives both the expanded ids and the features, which then travel with the
``LLMCall`` into the ``TrainingText``, so engine and trainer see the same
pixels.

``HFVisualProcessor`` serves a Qwen2.5-VL checkpoint directory without
transformers: it renders the checkpoint's chat template with the port's
``HFTokenizer`` (an image part becomes ``<|vision_start|><|image_pad|>
<|vision_end|>``) and expands each ``<|image_pad|>`` into one per merged
visual token, as Qwen2.5-VL's processor does. Its image parts carry what
Qwen2.5-VL's image processor outputs, ``{"type": "image", "image":
{"pixel_values": [N, patch_dim], "image_grid_thw": [t, h, w]}}``, the toy
processor's image parts. A raw image (a PIL image, bytes, an array or a
``data:`` URL) raises: the image pipeline (PNG decode, ``smart_resize``,
bicubic resize, normalize, patchify) without PIL or transformers is ROADMAP
Queue 1 item 13.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Protocol

import numpy as np

IMAGE_PIPELINE_ITEM = "ROADMAP Queue 1, item 13"


class VisualProcessorLike(Protocol):
    def __call__(self, messages: list[dict], tools: list[dict] | None = None) -> tuple[list[int], dict]: ...


def image_features(part: dict) -> dict:
    """The ``{"pixel_values", "image_grid_thw"}`` an image part carries;
    a raw image raises a ``ValueError`` that names the image pipeline's
    ROADMAP item."""
    img = part.get("image") if part.get("type") == "image" else None
    if isinstance(img, dict) and "pixel_values" in img and "image_grid_thw" in img:
        return img
    kind = "an image_url part" if part.get("type") == "image_url" else f"an image of type {type(img).__name__}"
    raise ValueError(
        f"{kind}: decoding and resizing raw images (PNG decode, smart_resize, bicubic resize, normalize, "
        f"patchify) is not ported ({IMAGE_PIPELINE_ITEM}); pass the image processor's features "
        '{"pixel_values": [N, patch_dim], "image_grid_thw": [t, h, w]}'
    )


def extract_images(messages: list[dict]) -> list[dict]:
    """The features of every image part, in message order."""
    images = []
    for m in messages:
        content = m.get("content")
        if isinstance(content, list):
            images += [image_features(p) for p in content if p.get("type") in ("image", "image_url")]
    return images


class HFVisualProcessor:
    """The processor of a Qwen2.5-VL checkpoint directory: its chat template
    through the port's tokenizer, one ``<|image_pad|>`` per merged visual
    token."""

    image_token = "<|image_pad|>"

    def __init__(self, model_dir: str | Path, tokenizer=None):
        from ..models.hf_tokenizer import HFTokenizer

        self.tokenizer = tokenizer if tokenizer is not None else HFTokenizer(model_dir)
        config = json.loads((Path(model_dir) / "config.json").read_text())
        self.merge = int((config.get("vision_config") or {}).get("spatial_merge_size", 2))
        self.image_token_id = self.tokenizer.token_to_id(self.image_token)
        if self.image_token_id is None:
            raise ValueError(f"{model_dir}: the tokenizer has no {self.image_token} token")

    def __call__(self, messages: list[dict], tools: list[dict] | None = None) -> tuple[list[int], dict | None]:
        images = extract_images(messages)
        text = self.tokenizer.apply_chat_template(messages, add_generation_prompt=True, tokenize=False, tools=tools)
        pieces = text.split(self.image_token)
        if len(pieces) - 1 != len(images):
            raise ValueError(f"the chat template placed {len(pieces) - 1} image tokens for {len(images)} images")
        expanded = pieces[0]
        for img, piece in zip(images, pieces[1:]):
            t, h, w = (int(x) for x in np.asarray(img["image_grid_thw"]).reshape(-1))
            expanded += self.image_token * (t * h * w // self.merge**2) + piece
        ids = self.tokenizer.encode(expanded, add_special_tokens=False)
        visual = None
        if images:
            visual = {
                "pixel_values": np.concatenate([np.asarray(i["pixel_values"], np.float32) for i in images]),
                "image_grid_thw": np.asarray([np.asarray(i["image_grid_thw"]).reshape(-1) for i in images], np.int64),
            }
        return ids, visual
