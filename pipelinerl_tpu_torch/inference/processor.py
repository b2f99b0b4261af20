"""Visual processors: OpenAI-style multimodal messages to (prompt token ids
with image placeholders, the image features).

Port of the JAX package's ``inference/processor.py``. One processor call
gives both the expanded ids and the features, which then travel with the
``LLMCall`` into the ``TrainingText``, so engine and trainer see the same
pixels.

``HFVisualProcessor`` serves a Qwen2.5-VL checkpoint directory without
transformers or PIL: it renders the checkpoint's chat template with the
port's ``HFTokenizer`` (an image part becomes ``<|vision_start|>
<|image_pad|><|vision_end|>``) and expands each ``<|image_pad|>`` into one
per merged visual token, as Qwen2.5-VL's processor does. An image part is
what the JAX ``decode_message_image`` accepts: an ``image_url`` part with a
``data:`` URL, or ``{"type": "image", "image": ...}`` with PNG, JPEG, GIF,
BMP, WebP or TIFF bytes, a
uint8 array (``[H, W]`` grey, ``[H, W, 3]`` RGB, ``[H, W, 4]`` RGBA, as
``Image.fromarray`` reads them) or an object with ``__array_interface__``
(a PIL image). Raw images go through ``inference/image_pipeline.py`` (the
file's decode, ``smart_resize``, PIL's bicubic resize, rescale and
normalize, patchify) with the checkpoint's ``preprocessor_config.json``. An image
part may also carry the image processor's output, ``{"pixel_values":
[N, patch_dim], "image_grid_thw": [t, h, w]}``, which passes as it is.
"""

from __future__ import annotations

import base64
import json
from pathlib import Path
from typing import Any, Protocol

import numpy as np

from .image_pipeline import DECODED_FORMATS, ImageProcessor, decode_image


class VisualProcessorLike(Protocol):
    def __call__(self, messages: list[dict], tools: list[dict] | None = None) -> tuple[list[int], dict]: ...


def array_to_rgb(image: Any) -> np.ndarray:
    """The RGB uint8 [H, W, 3] of an array as ``Image.fromarray(...)
    .convert("RGB")`` reads it: uint8 [H, W] as L, [H, W, 2] as LA,
    [H, W, 3] as RGB, [H, W, 4] as RGBA (alpha dropped), bool [H, W] as a
    1-bit image. An object with ``__array_interface__`` is read through
    it; one in PIL's "P" mode is looked up in its ``getpalette()``."""
    mode = getattr(image, "mode", None)
    array = np.asarray(image)
    if mode == "P" and hasattr(image, "getpalette"):
        palette = np.zeros((256, 3), np.uint8)
        entries = np.asarray(image.getpalette() or [], np.uint8).reshape(-1, 3)[:256]
        palette[: len(entries)] = entries
        return palette[array]
    if mode is not None and mode not in ("1", "L", "LA", "RGB", "RGBA"):
        raise ValueError(f"an image in mode {mode!r}: pass it converted to RGB")
    if array.dtype == np.bool_ and array.ndim == 2:
        array = array.astype(np.uint8) * 255
    if array.dtype != np.uint8 or not (array.ndim == 2 or (array.ndim == 3 and array.shape[2] in (2, 3, 4))):
        raise ValueError(f"an image array of dtype {array.dtype} and shape {list(array.shape)}: the image pipeline "
                         "takes uint8 [H, W], [H, W, 2], [H, W, 3] or [H, W, 4] (or bool [H, W])")
    if array.ndim == 2 or array.shape[2] == 2:
        return np.repeat((array if array.ndim == 2 else array[..., 0])[..., None], 3, axis=2)
    return np.ascontiguousarray(array[..., :3])


def image_source(part: dict) -> Any:
    """What an image part holds: the file's bytes for an ``image_url`` part's
    ``data:`` URL (as the JAX package, no other URL: no egress), else its
    ``image``."""
    if part.get("type") == "image_url":
        url = part["image_url"]["url"] if isinstance(part.get("image_url"), dict) else part["image_url"]
        if not url.startswith("data:"):
            raise ValueError("only data: URLs are supported (no egress)")
        return base64.b64decode(url.split(",", 1)[1])
    return part.get("image")


def source_features(source: Any, image_processor: ImageProcessor | None) -> dict:
    """The ``{"pixel_values", "image_grid_thw"}`` of what an image part
    holds: the features themselves, or a raw image (an image file's bytes,
    an array, an object with ``__array_interface__``) decoded to RGB and run through
    ``image_processor``; a raw image without one raises."""
    if isinstance(source, dict) and "pixel_values" in source and "image_grid_thw" in source:
        return source
    if isinstance(source, (bytes, bytearray, memoryview)):
        rgb = decode_image(bytes(source))
    elif isinstance(source, np.ndarray) or hasattr(source, "__array_interface__"):
        rgb = array_to_rgb(source)
    else:
        raise ValueError(f"an image of type {type(source).__name__}: pass the bytes of a {DECODED_FORMATS} file, a "
                         'data: URL, a uint8 array or the image processor\'s features {"pixel_values": [N, patch_dim], '
                         '"image_grid_thw": [t, h, w]}')
    if image_processor is None:
        raise ValueError("a raw image needs the checkpoint's preprocessor_config.json (the image processor's "
                         "settings), and there is none")
    pixels, grid = image_processor(rgb)
    return {"pixel_values": pixels, "image_grid_thw": list(grid)}


def extract_images(messages: list[dict], image_processor: ImageProcessor | None = None) -> list[dict]:
    """The features of every image part, in message order."""
    return [source_features(image_source(p), image_processor) for m in messages
            if isinstance(m.get("content"), list) for p in m["content"] if p.get("type") in ("image", "image_url")]


class HFVisualProcessor:
    """The processor of a Qwen2.5-VL checkpoint directory: its chat template
    through the port's tokenizer, one ``<|image_pad|>`` per merged visual
    token, raw images through the image pipeline with the directory's
    ``preprocessor_config.json``."""

    image_token = "<|image_pad|>"

    def __init__(self, model_dir: str | Path, tokenizer=None):
        from ..models.hf_tokenizer import HFTokenizer

        self.tokenizer = tokenizer if tokenizer is not None else HFTokenizer(model_dir)
        config = json.loads((Path(model_dir) / "config.json").read_text())
        self.merge = int((config.get("vision_config") or {}).get("spatial_merge_size", 2))
        self.image_token_id = self.tokenizer.token_to_id(self.image_token)
        if self.image_token_id is None:
            raise ValueError(f"{model_dir}: the tokenizer has no {self.image_token} token")
        self.image_processor = None
        if (Path(model_dir) / "preprocessor_config.json").exists():
            self.image_processor = ImageProcessor.from_pretrained(model_dir)

    def __call__(self, messages: list[dict], tools: list[dict] | None = None) -> tuple[list[int], dict | None]:
        images = extract_images(messages, self.image_processor)
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
