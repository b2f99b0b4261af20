"""Qwen2.5-VL's image pipeline on numpy and the stdlib: PNG in, the image
processor's ``pixel_values`` and ``image_grid_thw`` out.

It stands in for what ``PIL.Image.open(...).convert("RGB")`` and
transformers' ``Qwen2VLImageProcessor`` do for the JAX package
(``inference/processor.py``), neither of which the H100 host has:

- ``decode_png``: every colour type and bit depth the PNG standard allows,
  the five row filters and Adam7 interlace, CRCs checked, converted to RGB
  as PIL's ``convert("RGB")`` converts (alpha dropped, not composited; a
  palette looked up, entries past ``PLTE`` black; grey
  replicated; 16-bit colour and alpha samples by their high byte, 16-bit
  grey clipped at 255). The row filters run as one numpy step per
  anti-diagonal of the image: pixel (r, x) needs only (r, x-1), (r-1, x)
  and (r-1, x-1), so every row advances at once, whatever its filter.
- ``smart_resize``: transformers' copy, factor ``patch_size * merge_size``.
- ``resize_bicubic``: PIL's two-pass 8-bit bicubic (``Resample.c``): the
  a = -0.5 cubic with its support widened by the downscale factor,
  coefficients normalised in double precision and made fixed point at 22
  bits, the horizontal pass first with its rows clipped to uint8, PIL's
  window bounds and rounding. Coefficient matrices are precomputed and
  each tap gathered for every output pixel at once.
- ``ImageProcessor``: rescale and normalize in the dtypes transformers
  uses (float64 times the factor, cast to float32; float32 mean and std),
  then the temporal repeat and the patchify into rows of
  ``C * T * P * P`` in Qwen2-VL's merge order.
- ``encode_png``: 8-bit grey, RGB or RGBA through zlib, each row's filter
  chosen by the least sum of absolute signed bytes, as PIL's encoder
  chooses, so the port's own files carry all five filters.

Other image formats raise, naming ROADMAP Queue 1 item 16. This module
imports no torch: the host-only actor runs it.
"""

from __future__ import annotations

import json
import math
import struct
import zlib
from dataclasses import dataclass
from pathlib import Path

import numpy as np

OTHER_FORMATS_ITEM = "ROADMAP Queue 1, item 16"
PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# (bit depths allowed, channels) of each PNG colour type
_COLOR_TYPES = {0: ((1, 2, 4, 8, 16), 1), 2: ((8, 16), 3), 3: ((1, 2, 4, 8), 1), 4: ((8, 16), 2), 6: ((8, 16), 4)}
# Adam7's passes: (x start, y start, x step, y step)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
# transformers' OPENAI_CLIP_MEAN and OPENAI_CLIP_STD, the image processor's defaults
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
BICUBIC = 3  # PIL's Resampling.BICUBIC, the image processor's ``resample``
PRECISION_BITS = 32 - 8 - 2  # PIL's fixed point for 8-bit resampling


def unsupported_format(data: bytes) -> ValueError:
    """The refusal of an image that is not a PNG."""
    kind = "a JPEG image" if data[:3] == b"\xff\xd8\xff" else f"an image that is not a PNG (starts {data[:8]!r})"
    return ValueError(f"{kind}: only PNG is decoded without PIL; other image formats are {OTHER_FORMATS_ITEM}")


# -- PNG decode ----------------------------------------------------------------


def _chunks(data: bytes):
    """(type, payload) of each chunk, CRCs checked, up to and with IEND."""
    if data[:8] != PNG_SIGNATURE:
        raise unsupported_format(data)
    pos = 8
    while True:
        if pos + 8 > len(data):
            raise ValueError(f"truncated PNG: the file ends at byte {len(data)} before a chunk header (no IEND)")
        length, kind = struct.unpack(">I4s", data[pos : pos + 8])
        end = pos + 8 + length
        if end + 4 > len(data):
            raise ValueError(f"truncated PNG: chunk {kind!r} of {length} bytes at byte {pos} runs past the file's "
                             f"{len(data)} bytes")
        payload = data[pos + 8 : end]
        (crc,) = struct.unpack(">I", data[end : end + 4])
        if zlib.crc32(kind + payload) != crc:
            raise ValueError(f"corrupt PNG: chunk {kind!r} at byte {pos} fails its CRC")
        yield kind, payload
        if kind == b"IEND":
            return
        pos = end + 4


def _unfilter(rows: np.ndarray, bpp: int) -> np.ndarray:
    """The reconstructed bytes [h, stride] of filtered rows [h, 1 + stride],
    ``bpp`` bytes a pixel (1 below 8 bits). One numpy step per
    anti-diagonal of the pixel grid: every row advances at once."""
    h, stride = rows.shape[0], rows.shape[1] - 1
    kinds = rows[:, 0].astype(np.int32)
    if kinds.size and kinds.max() > 4:
        raise ValueError(f"corrupt PNG: row filter type {int(kinds.max())} (0-4 exist)")
    x = rows[:, 1:]
    if not kinds.any():
        return x.copy()
    wp = stride // bpp
    x = x.reshape(h, wp, bpp)
    # skewed: anti-diagonal d = r + c is row d + 2 of ``skew``, indexed by
    # the shorter side's coordinate k plus 1, so that the left (a), upper
    # (b) and upper-left (ul) neighbours are contiguous slices of rows
    # d + 1 and d; index 0 and the rows before 2 are the zero border
    by_row = h <= wp
    side = (h if by_row else wp) + 1
    r, c = np.indices((h, wp))
    place = ((r + c + 2) * side + (r if by_row else c) + 1).ravel()
    skew = np.zeros(((h + wp + 1) * side, bpp), np.int16)
    xs = np.zeros_like(skew)
    xs[place] = x.reshape(-1, bpp)
    # each pixel's filter type, laid out as the pixels are
    kind = np.zeros((h + wp + 1) * side, np.int8)
    kind[place] = kinds[r.ravel()]
    skew, xs, kind = skew.reshape(-1, side, bpp), xs.reshape(-1, side, bpp), kind.reshape(-1, side, 1)
    # which anti-diagonals hold an Average or a Paeth row
    slow = np.zeros((h + wp + 1, 2), bool)
    for j, f in enumerate((3, 4)):
        rows = np.flatnonzero(kinds == f)
        if rows.size:
            slow[(rows[:, None] + np.arange(wp)[None, :] + 2).ravel(), j] = True
    for d in range(h + wp - 1):
        if by_row:
            k0, k1 = max(0, d - wp + 1), min(h - 1, d) + 1
            a, b = skew[d + 1, k0 + 1 : k1 + 1], skew[d + 1, k0:k1]
        else:
            k0, k1 = max(0, d - h + 1), min(wp - 1, d) + 1
            a, b = skew[d + 1, k0:k1], skew[d + 1, k0 + 1 : k1 + 1]
        here = slice(k0 + 1, k1 + 1)
        f = kind[d + 2, here]
        pred = np.where(f == 1, a, np.where(f == 2, b, 0))
        if slow[d + 2, 0]:
            pred = np.where(f == 3, (a + b) >> 1, pred)
        if slow[d + 2, 1]:
            ul = skew[d, k0:k1]
            pa, pb, pc = np.abs(b - ul), np.abs(a - ul), np.abs(a + b - 2 * ul)
            pred = np.where(f == 4, np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, ul)), pred)
        skew[d + 2, here] = (xs[d + 2, here] + pred) & 0xFF
    return skew.reshape(-1, bpp)[place].reshape(h, stride).astype(np.uint8)


def _samples(raw: np.ndarray, w: int, depth: int, channels: int) -> np.ndarray:
    """The samples [h, w, channels] of reconstructed rows [h, stride]."""
    h = raw.shape[0]
    if depth == 8:
        return raw[:, : w * channels].reshape(h, w, channels)
    if depth == 16:  # big-endian
        pairs = raw[:, : 2 * w * channels].reshape(h, w, channels, 2).astype(np.uint16)
        return (pairs[..., 0] << 8) | pairs[..., 1]
    per = 8 // depth
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    unpacked = (raw[:, :, None] >> shifts) & ((1 << depth) - 1)
    return unpacked.reshape(h, raw.shape[1] * per)[:, :w, None]


def _to_rgb(samples: np.ndarray, color: int, depth: int, palette: np.ndarray | None) -> np.ndarray:
    """``convert("RGB")`` of the image PIL opens from these samples."""
    if color == 3:
        return palette[samples[..., 0]]
    if depth == 16:  # PIL keeps the high byte; 16-bit grey ("I;16") clips
        samples = np.minimum(samples, 255) if color == 0 else samples >> 8
    elif depth < 8:  # "1", "L;2", "L;4": scaled to 8 bits
        samples = samples * (255 // ((1 << depth) - 1))
    samples = samples.astype(np.uint8)
    if color in (0, 4):
        return np.repeat(samples[..., :1], 3, axis=-1)
    return np.ascontiguousarray(samples[..., :3])


def decode_png(data: bytes) -> np.ndarray:
    """The RGB uint8 image [H, W, 3] of a PNG file, as PIL's
    ``Image.open(...).convert("RGB")`` gives it; a truncated or corrupt
    file raises ``ValueError`` saying what is wrong."""
    data = bytes(data)
    header, palette, idat = None, None, []
    for kind, payload in _chunks(data):
        if header is None and kind != b"IHDR":
            raise ValueError(f"corrupt PNG: the first chunk is {kind!r}, not IHDR")
        if kind == b"IHDR":
            if len(payload) != 13:
                raise ValueError(f"corrupt PNG: IHDR holds {len(payload)} bytes, not 13")
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"PLTE":
            if len(payload) % 3 or not 0 < len(payload) <= 768:
                raise ValueError(f"corrupt PNG: a PLTE of {len(payload)} bytes")
            # entries past PLTE read black, as in PIL
            palette = np.zeros((256, 3), np.uint8)
            palette[: len(payload) // 3] = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(payload)
    width, height, depth, color, compression, filtering, interlace = header
    if color not in _COLOR_TYPES or depth not in _COLOR_TYPES[color][0]:
        raise ValueError(f"corrupt PNG: bit depth {depth} with colour type {color}")
    if compression or filtering or interlace > 1:
        raise ValueError(f"corrupt PNG: compression {compression}, filter method {filtering}, interlace {interlace}")
    if not width or not height:
        raise ValueError(f"corrupt PNG: a {width}x{height} image")
    if color == 3 and palette is None:
        raise ValueError("corrupt PNG: a palette image without PLTE")
    if not idat:
        raise ValueError("corrupt PNG: no IDAT chunk")
    inflate = zlib.decompressobj()
    try:
        raw = inflate.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"corrupt PNG: the image data does not inflate ({e})") from e
    if not inflate.eof:
        raise ValueError("truncated PNG: the image data's zlib stream ends early")
    channels = _COLOR_TYPES[color][1]
    bits = depth * channels
    bpp = max(1, bits // 8)
    passes = _ADAM7 if interlace else ((0, 0, 1, 1),)
    image = np.zeros((height, width, channels), np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for x0, y0, dx, dy in passes:
        w, h = -(-(width - x0) // dx), -(-(height - y0) // dy)
        if w <= 0 or h <= 0:
            continue
        stride = (w * bits + 7) // 8
        size = h * (stride + 1)
        if pos + size > len(raw):
            raise ValueError(f"truncated PNG: the image data holds {len(raw)} bytes, fewer than its rows need")
        rows = np.frombuffer(raw, np.uint8, size, pos).reshape(h, stride + 1)
        pos += size
        image[y0::dy, x0::dx] = _samples(_unfilter(rows, bpp), w, depth, channels)
    return _to_rgb(image, color, depth, palette)


# -- PNG encode ----------------------------------------------------------------


def _chunk(kind: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", len(payload)) + kind + payload + struct.pack(">I", zlib.crc32(kind + payload))


def encode_png(image: np.ndarray, level: int = 6) -> bytes:
    """A PNG file of an 8-bit grey [H, W], RGB [H, W, 3] or RGBA [H, W, 4]
    array; each row takes the filter whose bytes, read as signed, have the
    least sum of absolute values (ties to the lower filter type)."""
    image = np.asarray(image)
    if image.dtype != np.uint8:
        raise ValueError(f"encode_png takes uint8 arrays, not {image.dtype}")
    if image.ndim == 2:
        image = image[..., None]
    if image.ndim != 3 or image.shape[2] not in (1, 3, 4) or not image.shape[0] or not image.shape[1]:
        raise ValueError(f"encode_png takes [H, W], [H, W, 3] or [H, W, 4], not {list(image.shape)}")
    h, w, ch = image.shape
    x = image.reshape(h, w * ch)
    a = np.zeros_like(x)
    a[:, ch:] = x[:, :-ch]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    ul = np.zeros_like(x)
    ul[1:, ch:] = x[:-1, :-ch]
    a16, b16, ul16 = a.astype(np.int16), b.astype(np.int16), ul.astype(np.int16)
    pa, pb, pc = np.abs(b16 - ul16), np.abs(a16 - ul16), np.abs(a16 + b16 - 2 * ul16)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, ul))
    avg = ((a16 + b16) >> 1).astype(np.uint8)
    filtered = np.stack([x, x - a, x - b, x - avg, x - paeth])  # [5, h, stride], uint8 arithmetic wraps
    # |v| of each byte read as signed: min(v, 256 - v)
    cost = np.minimum(filtered, 0 - filtered).sum(-1, dtype=np.int64)  # [5, h]
    kinds = cost.argmin(0)
    rows = np.concatenate([kinds[:, None].astype(np.uint8), filtered[kinds, np.arange(h)]], axis=1)
    color = {1: 0, 3: 2, 4: 6}[ch]
    return (PNG_SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level)) + _chunk(b"IEND", b""))


# -- resize --------------------------------------------------------------------


def smart_resize(height: int, width: int, factor: int = 28, min_pixels: int = 56 * 56,
                 max_pixels: int = 14 * 14 * 4 * 1280) -> tuple[int, int]:
    """transformers' ``smart_resize`` (Qwen2-VL): both sides multiples of
    ``factor``, the area within [min_pixels, max_pixels], the aspect ratio
    kept as closely as that allows; an aspect ratio above 200 raises."""
    if max(height, width) / min(height, width) > 200:
        raise ValueError(f"absolute aspect ratio must be smaller than 200, got {max(height, width) / min(height, width)}")
    h_bar = round(height / factor) * factor
    w_bar = round(width / factor) * factor
    if h_bar * w_bar > max_pixels:
        beta = math.sqrt((height * width) / max_pixels)
        h_bar = max(factor, math.floor(height / beta / factor) * factor)
        w_bar = max(factor, math.floor(width / beta / factor) * factor)
    elif h_bar * w_bar < min_pixels:
        beta = math.sqrt(min_pixels / (height * width))
        h_bar = math.ceil(height * beta / factor) * factor
        w_bar = math.ceil(width * beta / factor) * factor
    return h_bar, w_bar


def _cubic(x: np.ndarray) -> np.ndarray:
    """PIL's ``bicubic_filter`` (a = -0.5), in its order of operations."""
    a = -0.5
    x = np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


def resize_coefficients(in_size: int, out_size: int) -> tuple[np.ndarray, np.ndarray]:
    """PIL's ``precompute_coeffs`` and ``normalize_coeffs_8bpc`` for one
    axis: (the input index of each tap [out, ksize], its fixed-point
    coefficient [out, ksize]); taps past a window's end weigh 0."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum((center + support + 0.5).astype(np.int64), in_size) - xmin
    taps = np.arange(ksize)
    live = taps[None, :] < xmax[:, None]
    k = np.where(live, _cubic(((taps[None, :] + xmin[:, None]) - center[:, None] + 0.5) * (1.0 / filterscale)), 0.0)
    ww = np.zeros(out_size)
    for t in range(ksize):  # summed in PIL's order
        ww = ww + k[:, t]
    k = np.where(ww[:, None] != 0.0, k / np.where(ww == 0.0, 1.0, ww)[:, None], k)
    scaled = k * (1 << PRECISION_BITS)
    fixed = np.trunc(np.where(k < 0, -0.5 + scaled, 0.5 + scaled)).astype(np.int64)
    index = np.minimum(xmin[:, None] + taps[None, :], in_size - 1)
    return index, np.where(live, fixed, 0)


def _resample_axis(image: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    index, coeff = resize_coefficients(image.shape[axis], out_size)
    # int32 as in PIL: 255 times the taps' absolute sum stays below 2^31
    acc = np.full(image.shape[:axis] + (out_size,) + image.shape[axis + 1 :], 1 << (PRECISION_BITS - 1), np.int32)
    shape = [1] * image.ndim
    shape[axis] = out_size
    coeff = coeff.astype(np.int32)
    for t in range(index.shape[1]):
        acc += np.take(image, index[:, t], axis=axis) * coeff[:, t].reshape(shape)
    return np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)


def resize_bicubic(image: np.ndarray, height: int, width: int) -> np.ndarray:
    """PIL's ``Image.resize((width, height), BICUBIC)`` of an 8-bit image
    [H, W] or [H, W, C]: the horizontal pass, clipped to uint8, then the
    vertical pass; a resize to the same size is a copy."""
    image = np.asarray(image)
    if image.dtype != np.uint8:
        raise ValueError(f"resize_bicubic takes uint8 images, not {image.dtype}")
    out = image
    if width != image.shape[1]:
        out = _resample_axis(out, width, 1)
    if height != image.shape[0]:
        out = _resample_axis(out, height, 0)
    return out.copy() if out is image else out


# -- the image processor -------------------------------------------------------


@dataclass
class ImageProcessor:
    """Qwen2-VL's image processor (transformers' ``Qwen2VLImageProcessor``)
    on an RGB uint8 image, with its ``preprocessor_config.json`` keys and
    defaults."""

    do_resize: bool = True
    resample: int = BICUBIC
    do_rescale: bool = True
    rescale_factor: float = 1 / 255
    do_normalize: bool = True
    image_mean: tuple = CLIP_MEAN
    image_std: tuple = CLIP_STD
    min_pixels: int = 56 * 56
    max_pixels: int = 28 * 28 * 1280
    patch_size: int = 14
    temporal_patch_size: int = 2
    merge_size: int = 2

    @classmethod
    def from_dict(cls, config: dict) -> "ImageProcessor":
        """From ``preprocessor_config.json``'s keys; ``size``'s
        ``shortest_edge``/``longest_edge`` stand for absent ``min_pixels``/
        ``max_pixels`` (transformers 4.57's constructor drops a ``size``
        and keeps its defaults; Qwen2.5-VL's published configs carry
        ``min_pixels`` and ``max_pixels``, which both read alike)."""
        size = config.get("size") or {}
        known = {k: config[k] for k in cls.__dataclass_fields__ if k in config and config[k] is not None}
        if "min_pixels" not in known and "shortest_edge" in size:
            known["min_pixels"] = size["shortest_edge"]
        if "max_pixels" not in known and "longest_edge" in size:
            known["max_pixels"] = size["longest_edge"]
        out = cls(**known)
        if out.do_resize and int(out.resample) != BICUBIC:
            raise ValueError(f"resample {out.resample}: only bicubic ({BICUBIC}) resizing is ported")
        return out

    @classmethod
    def from_pretrained(cls, model_dir: str | Path) -> "ImageProcessor":
        """From a checkpoint directory's ``preprocessor_config.json``, as
        ``AutoProcessor`` reads it."""
        return cls.from_dict(json.loads((Path(model_dir) / "preprocessor_config.json").read_text()))

    def __call__(self, image: np.ndarray) -> tuple[np.ndarray, tuple[int, int, int]]:
        """(pixel_values [t * h * w, C * T * P * P] float32, (t, h, w)) of
        one RGB uint8 image [H, W, 3]."""
        height, width = image.shape[:2]
        if self.do_resize:
            height, width = smart_resize(height, width, self.patch_size * self.merge_size, self.min_pixels,
                                         self.max_pixels)
            image = resize_bicubic(image, height, width)
        if self.do_rescale:
            image = (image.astype(np.float64) * self.rescale_factor).astype(np.float32)
        if self.do_normalize:
            if not np.issubdtype(image.dtype, np.floating):
                image = image.astype(np.float32)
            image = (image - np.array(self.image_mean, image.dtype)) / np.array(self.image_std, image.dtype)
        patches = image.transpose(2, 0, 1)[None]  # [frames, C, H, W]
        T, P, M = self.temporal_patch_size, self.patch_size, self.merge_size
        if patches.shape[0] % T:
            patches = np.concatenate([patches, np.repeat(patches[-1:], T - patches.shape[0] % T, axis=0)])
        c = patches.shape[1]
        gt, gh, gw = patches.shape[0] // T, height // P, width // P
        patches = patches.reshape(gt, T, c, gh // M, M, P, gw // M, M, P).transpose(0, 3, 6, 4, 7, 2, 1, 5, 8)
        return patches.reshape(gt * gh * gw, c * T * P * P).astype(np.float32), (gt, gh, gw)
