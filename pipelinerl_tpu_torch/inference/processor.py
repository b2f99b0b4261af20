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
``data:`` URL, or ``{"type": "image", "image": ...}`` with the bytes of a
file in any format of ``image_pipeline.DECODED_FORMATS`` (PNG, JPEG, GIF,
BMP, WebP, TIFF, ICO, CUR, Netpbm, TGA, QOI, PCX, SGI, XBM, XPM), an array
of any type ``Image.fromarray`` reads, or an object with ``mode`` and
``__array_interface__`` (a PIL image, in any mode ``array_to_rgb`` lists),
each converted as PIL's ``convert("RGB")`` converts it. Raw images go
through ``inference/image_pipeline.py`` (the file's decode,
``smart_resize``, PIL's bicubic resize, rescale and normalize, patchify)
with the checkpoint's ``preprocessor_config.json``. An image part may also
carry the image processor's output, ``{"pixel_values": [N, patch_dim],
"image_grid_thw": [t, h, w]}``, which passes as it is.
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


# PIL's ``Image.fromarray``: the mode of a 2-D array of each type (a
# 3-D one is uint8 only), as ``typestr`` without its byte order
_FROMARRAY_2D = {"b1": "1", "u1": "L", "i1": "I", "u2": "I;16", "i2": "I", "u4": "I", "i4": "I", "f4": "F",
                 "f8": "F"}
_FROMARRAY_3D = {2: "LA", 3: "RGB", 4: "RGBA"}
# PIL's YCbCr to RGB tables (``ConvertYCbCr.c``): each coefficient times 64
# at every offset from 128, made an integer by C's truncation after + 0.5
_YCC = {name: np.trunc(c * 64 * (np.arange(256) - 128) + 0.5).astype(np.int32)
        for name, c in (("R_Cr", 1.402), ("G_Cb", -0.34414), ("G_Cr", -0.71414), ("B_Cb", 1.772))}


def _refusal(what: str) -> ValueError:
    return ValueError(f"{what}, which PIL does not convert to RGB either (ROADMAP Queue 1, item 16)")


def _fromarray_mode(array: np.ndarray) -> str:
    """The mode ``Image.fromarray`` gives ``array``; a type it cannot handle
    raises, as it raises."""
    kind = array.dtype.str[1:]
    mode = _FROMARRAY_2D.get(kind) if array.ndim == 2 else None
    if array.ndim == 3 and kind == "u1":
        mode = _FROMARRAY_3D.get(array.shape[2])
    if mode is None:
        raise _refusal(f"an image array of dtype {array.dtype} and shape {list(array.shape)}: PIL cannot handle "
                       f"this data type ({(1, 1) + array.shape[2:]}, {array.dtype.str})")
    return mode


def _hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    """PIL's ``hsv2rgb`` (``Convert.c``): the sextant and its fraction in
    double precision, the fraction and the saturation kept as C floats,
    each product rounded half away from zero."""
    h, s, v = (hsv[..., i].astype(np.float64) for i in range(3))
    x = h * 6.0 / 255.0
    sextant = np.floor(x)
    f = (x - sextant).astype(np.float32).astype(np.float64)
    fs = (s / 255.0).astype(np.float32).astype(np.float64)

    def rounded(a):
        return np.clip(np.where(a >= 0, np.floor(a + 0.5), np.ceil(a - 0.5)), 0, 255)

    p, q, t = rounded(v * (1.0 - fs)), rounded(v * (1.0 - fs * f)), rounded(v * (1.0 - fs * (1.0 - f)))
    order = [(v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v), (v, p, q)]
    k = sextant.astype(np.int64) % 6
    out = np.stack([np.choose(k, [o[c] for o in order]) for c in range(3)], axis=-1)
    out[s == 0] = v[s == 0][:, None]
    return out.astype(np.uint8)


def array_to_rgb(image: Any) -> np.ndarray:
    """The RGB uint8 [H, W, 3] of a raw image as PIL's ``convert("RGB")``
    gives it, bit for bit: an array as ``Image.fromarray`` reads it, or an
    object with ``mode`` and ``__array_interface__`` (a PIL image, duck
    typed: the H100 host has no PIL) in its mode.

    - Arrays: bool [H, W] as 1; uint8 [H, W] as L, [H, W, 2] as LA, [H, W,
      3] as RGB, [H, W, 4] as RGBA; int8 as I through unsigned bytes;
      uint16 as I;16; int16, int32 and uint32 (wrapped to int32) as I;
      float32 and float64 (rounded to float32) as F. Other types raise, as
      PIL raises.
    - Modes: 1, L, LA, RGB, RGBA, RGBX (alpha or pad dropped); P and PA
      through ``getpalette()`` (entries past it black); RGBa unpremultiplied
      (255·v // a but at a 0 or 255); CMYK as ``cmyk2rgb``; YCbCr through
      PIL's fixed-point tables; HSV as ``hsv2rgb``; I;16 (any byte order)
      clipped at 255; I clipped to [0, 255]; F clipped, then truncated (NaN
      reads 0).
    - La raises, as in PIL; LAB (PIL converts it through LittleCMS) and other
      modes raise, naming ROADMAP Queue 1 item 16."""
    mode = getattr(image, "mode", None)
    array = np.asarray(image)
    if mode is None:
        mode = _fromarray_mode(array)
    if mode in ("P", "PA") and hasattr(image, "getpalette"):
        palette = np.zeros((256, 3), np.uint8)
        entries = np.asarray(image.getpalette() or [], np.uint8).reshape(-1, 3)[:256]
        palette[: len(entries)] = entries
        return palette[array if mode == "P" else array[..., 0]]
    if mode == "1":
        array = (array != 0).astype(np.uint8) * 255
    elif mode in ("I;16", "I;16L", "I;16B", "I;16N"):
        array = np.minimum(array, 255).astype(np.uint8)
    elif mode == "I":
        if array.dtype.kind == "i" and array.dtype.itemsize == 1:
            array = array.view(np.uint8)
        elif array.dtype.kind == "u" and array.dtype.itemsize == 4:
            array = array.astype(array.dtype.newbyteorder("=")).view(np.int32)
        array = np.clip(array.astype(np.int64), 0, 255).astype(np.uint8)
    elif mode == "F":
        f = array.astype(np.float32)
        with np.errstate(invalid="ignore"):
            array = np.where(f >= 255, 255, np.where(f > 0, np.trunc(np.nan_to_num(f)), 0)).astype(np.uint8)
    elif mode == "La":
        raise _refusal("an image in mode 'La': conversion from La to L not supported")
    elif mode not in ("L", "LA", "RGB", "RGBA", "RGBX", "RGBa", "CMYK", "YCbCr", "HSV"):
        raise _refusal(f"an image in mode {mode!r}")
    if array.dtype != np.uint8 or not (array.ndim == 2 or (array.ndim == 3 and array.shape[2] in (2, 3, 4))):
        raise ValueError(f"an image in mode {mode!r} of dtype {array.dtype} and shape {list(array.shape)}")
    if array.ndim == 2 or mode in ("LA",):
        return np.repeat((array if array.ndim == 2 else array[..., 0])[..., None], 3, axis=2)
    if mode == "RGBa":
        alpha = array[..., 3:].astype(np.int32)
        scaled = np.minimum(255 * array[..., :3].astype(np.int32) // np.maximum(alpha, 1), 255)
        return np.where((alpha == 0) | (alpha == 255), array[..., :3], scaled).astype(np.uint8)
    if mode == "CMYK":
        nk = 255 - array[..., 3:].astype(np.int32)
        t = array[..., :3].astype(np.int32) * nk + 128
        return np.clip(nk - (((t >> 8) + t) >> 8), 0, 255).astype(np.uint8)
    if mode == "YCbCr":
        y, cb, cr = (array[..., i].astype(np.int32) for i in range(3))
        rgb = (y + (_YCC["R_Cr"][cr] >> 6), y + ((_YCC["G_Cb"][cb] + _YCC["G_Cr"][cr]) >> 6), y + (_YCC["B_Cb"][cb] >> 6))
        return np.clip(np.stack(rgb, axis=-1), 0, 255).astype(np.uint8)
    if mode == "HSV":
        return _hsv_to_rgb(array)
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
                         'data: URL, an array or the image processor\'s features {"pixel_values": [N, patch_dim], '
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
