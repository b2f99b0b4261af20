"""Qwen2.5-VL's image pipeline on numpy and the stdlib: an image file (PNG,
JPEG, GIF, BMP, WebP, TIFF, ICO, CUR, Netpbm, TGA, QOI, PCX, SGI, XBM or
XPM) in, the image processor's ``pixel_values`` and ``image_grid_thw`` out.

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
- ``decode_jpeg``: what PIL's ``convert("RGB")`` gives on libjpeg-turbo,
  bit for bit. The entropy decoder (baseline, extended and progressive
  Huffman, with restart intervals) is the one bit-serial part: it reads a
  32-bit window at each bit position of the unstuffed data and a 16-bit
  lookahead table that gives a code's symbol and length at once. The
  islow IDCT runs as two integer matrix passes over every block, then
  libjpeg-turbo's fancy upsampling and fixed-point colour tables.
- ``decode_image``: the file's first bytes pick the decoder: PNG and JPEG
  here, GIF (``image_gif``), BMP (``image_bmp``), WebP (``image_webp``),
  TIFF (``image_tiff``), ICO and CUR (``image_ico``), Netpbm
  (``image_netpbm``), QOI (``image_qoi``), PCX (``image_pcx``), SGI
  (``image_sgi``), XBM and XPM (``image_xbm``), and TGA
  (``image_tga``, which has no magic) where the rest decline, as
  ``Image.open`` tries its plugins; each what PIL's ``convert("RGB")``
  gives.
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

Other image formats (and the variants of these that are not read yet)
raise, naming ROADMAP Queue 1 item 16. This module imports no torch: the
host-only actor runs it.
"""

from __future__ import annotations

import functools
import json
import math
import struct
from array import array
import zlib
from dataclasses import dataclass
from pathlib import Path
from typing import Sequence

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


# (first bytes, format) by PIL's format names; the last group names formats
# PIL opens that no decoder here reads, for the refusal's message
_MAGIC = ((PNG_SIGNATURE, "PNG"), (b"\xff\xd8\xff", "JPEG"), (b"GIF87a", "GIF"), (b"GIF89a", "GIF"),
          (b"BM", "BMP"), (b"II*\x00", "TIFF"), (b"MM\x00*", "TIFF"), (b"II+\x00", "TIFF"), (b"MM\x00+", "TIFF"),
          (b"\0\0\2\0", "CUR"), (b"\0\0\1\0", "ICO"), (b"qoif", "QOI"), (b"\x01\xda", "SGI"),
          (b"/* XPM */", "XPM"),
          (b"%!PS", "EPS"), (b"\xc5\xd0\xd3\xc6", "EPS"), (b"BUFR", "BUFR"), (b"ZCZC", "BUFR"), (b"GRIB", "GRIB"),
          (b"\x89HDF\r\n\x1a\n", "HDF5"), (b"\x00\x00\x01\xb3", "MPEG"), (b"\xd7\xcd\xc6\x9a\x00\x00", "WMF"),
          (b"DDS ", "DDS"), (b"8BPS", "PSD"), (b"\xff\x4f\xff\x51", "JPEG2000"),
          (b"\x00\x00\x00\x0cjP  \r\n\x87\n", "JPEG2000"))


class Declined(ValueError):
    """A file that is not in a decoder's format after all: where Pillow's
    plugin raises ``SyntaxError`` (or ``IndexError``, ``TypeError``,
    ``struct.error``) in ``_open``, ``Image.open`` goes on to the plugins
    after it, and ``decode_image`` goes on to the decoders after this one
    (TGA, which has no magic, last)."""


def _magic_kinds(data: bytes) -> list[str]:
    """Every format whose first bytes ``data`` has, as PIL's plugins
    accept them."""
    kinds = [kind for magic, kind in _MAGIC if data.startswith(magic)]
    if kinds in (["CUR"], ["ICO"]) and data[4:6] in (b"", b"\0", b"\0\0"):  # no entries: Pillow goes on
        kinds = []
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        kinds.append("WebP")
    if data[:1] == b"\x0a" and data[1:2] in (b"\0", b"\2", b"\3", b"\5"):
        kinds.append("PCX")
    if data[:1] == b"P" and data[1:2] and data[1] in b"0123456fy":
        kinds.append("PPM")
    if data[:16].lstrip().startswith(b"#define"):
        kinds.append("XBM")
    if data[4:8] == b"ftyp" and data[8:12] in (b"avif", b"avis"):
        kinds.append("AVIF")
    return kinds


def image_kind(data: bytes) -> str:
    """The format an image file's first bytes name (TGA, which has no
    magic, where its header holds)."""
    kinds = _magic_kinds(data)
    if kinds:
        return kinds[0]
    from .image_tga import tga_header

    return "TGA" if tga_header(data) else f"unknown format (starts {data[:8]!r})"


DECODED_FORMATS = ("PNG, JPEG, GIF, BMP, WebP, TIFF, ICO, CUR, Netpbm (PBM, PGM, PPM and grey PFM), TGA, QOI, PCX, "
                   "SGI, XBM and XPM")


def unsupported_format(data: bytes) -> ValueError:
    """The refusal of an image in a format no decoder here reads."""
    return ValueError(f"a {image_kind(data)} image: only {DECODED_FORMATS} are decoded without PIL; other image "
                      f"formats are {OTHER_FORMATS_ITEM}")


def _decoders() -> dict:
    """The decoder of each format the port reads, by ``image_kind``."""
    from . import image_bmp, image_gif, image_ico, image_netpbm, image_pcx, image_qoi, image_sgi, image_tga
    from . import image_tiff, image_webp, image_xbm

    return {"PNG": decode_png, "JPEG": decode_jpeg, "GIF": image_gif.decode_gif, "BMP": image_bmp.decode_bmp,
            "WebP": image_webp.decode_webp, "TIFF": image_tiff.decode_tiff, "CUR": image_ico.decode_cur,
            "ICO": image_ico.decode_ico, "PCX": image_pcx.decode_pcx, "PPM": image_netpbm.decode_netpbm,
            "QOI": image_qoi.decode_qoi, "SGI": image_sgi.decode_sgi, "TGA": image_tga.decode_tga,
            "XBM": image_xbm.decode_xbm, "XPM": image_xbm.decode_xpm}


def wrong_decoder(data: bytes, expected: str) -> ValueError:
    """The refusal of a file handed to another format's decoder, naming
    the one that reads it."""
    decode = _decoders().get(image_kind(data))
    if decode is None:
        return unsupported_format(data)
    return ValueError(f"not a {expected} but a {image_kind(data)} file: {decode.__module__.rsplit('.', 1)[1]}."
                      f"{decode.__name__} reads it (decode_image picks it)")


def decode_image(data: bytes) -> np.ndarray:
    """The RGB uint8 image [H, W, 3] of an image file in any format of
    ``DECODED_FORMATS``, as PIL's ``Image.open(...).convert("RGB")`` gives
    it: the decoders whose magic the first bytes hold, in turn, then TGA,
    as ``Image.open`` tries its plugins; any other format raises, naming
    ROADMAP item 16."""
    data = bytes(data)
    decoders = _decoders()
    for kind in [*_magic_kinds(data), "TGA"]:
        if kind not in decoders:
            raise unsupported_format(data)
        try:
            return decoders[kind](data)
        except Declined:
            continue
    raise unsupported_format(data)


# -- PNG decode ----------------------------------------------------------------


def _chunks(data: bytes):
    """(type, payload) of each chunk, CRCs checked, up to and with IEND."""
    if data[:8] != PNG_SIGNATURE:
        raise wrong_decoder(data, "PNG")
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


# -- JPEG decode ---------------------------------------------------------------

JPEG_SOI = b"\xff\xd8"
# the natural (row-major) index of each zigzag position, and 16 more entries
# at 63 that absorb a run past the block's end, as libjpeg's table does
_ZIGZAG = [8 * i + s - i if s % 2 else 8 * i + s - i for s in range(15)
           for i in (range(max(0, s - 7), min(s, 7) + 1) if s % 2 else range(min(s, 7), max(0, s - 7) - 1, -1))]
NATURAL = _ZIGZAG + [63] * 16
# the standard tables of the JPEG standard's Annex K.3: (bits[1..16],
# values), which libjpeg-turbo uses for a table a file leaves undefined
STD_HUFFMAN = {
    (0, 0): ((0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0), tuple(range(12))),
    (0, 1): ((0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0), tuple(range(12))),
    (1, 0): ((0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D), bytes.fromhex(
        "01 02 03 00 04 11 05 12 21 31 41 06 13 51 61 07 22 71 14 32 81 91 a1 08 23 42 b1 c1 15 52 d1 f0 24 33 62 72"
        " 82 09 0a 16 17 18 19 1a 25 26 27 28 29 2a 34 35 36 37 38 39 3a 43 44 45 46 47 48 49 4a 53 54 55 56 57 58 59"
        " 5a 63 64 65 66 67 68 69 6a 73 74 75 76 77 78 79 7a 83 84 85 86 87 88 89 8a 92 93 94 95 96 97 98 99 9a a2 a3"
        " a4 a5 a6 a7 a8 a9 aa b2 b3 b4 b5 b6 b7 b8 b9 ba c2 c3 c4 c5 c6 c7 c8 c9 ca d2 d3 d4 d5 d6 d7 d8 d9 da e1 e2"
        " e3 e4 e5 e6 e7 e8 e9 ea f1 f2 f3 f4 f5 f6 f7 f8 f9 fa")),
    (1, 1): ((0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77), bytes.fromhex(
        "00 01 02 03 11 04 05 21 31 06 12 41 51 07 61 71 13 22 32 81 08 14 42 91 a1 b1 c1 09 23 33 52 f0 15 62 72 d1"
        " 0a 16 24 34 e1 25 f1 17 18 19 1a 26 27 28 29 2a 35 36 37 38 39 3a 43 44 45 46 47 48 49 4a 53 54 55 56 57 58"
        " 59 5a 63 64 65 66 67 68 69 6a 73 74 75 76 77 78 79 7a 82 83 84 85 86 87 88 89 8a 92 93 94 95 96 97 98 99 9a"
        " a2 a3 a4 a5 a6 a7 a8 a9 aa b2 b3 b4 b5 b6 b7 b8 b9 ba c2 c3 c4 c5 c6 c7 c8 c9 ca d2 d3 d4 d5 d6 d7 d8 d9 da"
        " e2 e3 e4 e5 e6 e7 e8 e9 ea f2 f3 f4 f5 f6 f7 f8 f9 fa")),
}
# libjpeg's islow IDCT (jidctint.c): CONST_BITS 13, PASS1_BITS 2
_FIX = {"0_298631336": 2446, "0_390180644": 3196, "0_541196100": 4433, "0_765366865": 6270, "0_899976223": 7373,
        "1_175875602": 9633, "1_501321110": 12299, "1_847759065": 15137, "1_961570560": 16069,
        "2_053119869": 16819, "2_562915447": 20995, "3_072711026": 25172}


def _islow_1d(x: list[int]) -> list[int]:
    """One pass of ``jpeg_idct_islow`` on eight inputs (frequencies 0-7),
    before its descale: integer sums only, so linear."""
    f = _FIX
    z1 = (x[2] + x[6]) * f["0_541196100"]
    tmp2 = z1 - x[6] * f["1_847759065"]
    tmp3 = z1 + x[2] * f["0_765366865"]
    tmp0 = (x[0] + x[4]) << 13
    tmp1 = (x[0] - x[4]) << 13
    tmp10, tmp13, tmp11, tmp12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x[7], x[5], x[3], x[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * f["1_175875602"]
    t0, t1, t2, t3 = t0 * f["0_298631336"], t1 * f["2_053119869"], t2 * f["3_072711026"], t3 * f["1_501321110"]
    z1, z2 = z1 * -f["0_899976223"], z2 * -f["2_562915447"]
    z3, z4 = z3 * -f["1_961570560"] + z5, z4 * -f["0_390180644"] + z5
    t0, t1, t2, t3 = t0 + z1 + z3, t1 + z2 + z4, t2 + z2 + z3, t3 + z1 + z4
    return [tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0, tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3]


# the pass as an 8x8 integer matrix: output r = sum_k W[r, k] * input k
_IDCT_W = np.array([_islow_1d([int(k == j) for k in range(8)]) for j in range(8)], np.float64).T
# libjpeg's post-IDCT range limit over a descaled value's low 10 bits:
# x + 128 clamped for |x| < 512, then the table's wrap
_IDCT_LIMIT = np.concatenate([np.arange(128, 256), np.full(384, 255), np.zeros(384), np.arange(128)]).astype(np.uint8)
# jdcolor.c's YCbCr → RGB tables (SCALEBITS 16, ONE_HALF rounding)
_X = np.arange(256, dtype=np.int64) - 128
_CR_R = (int(1.40200 * 65536 + 0.5) * _X + 32768) >> 16
_CB_B = (int(1.77200 * 65536 + 0.5) * _X + 32768) >> 16
_CR_G = -int(0.71414 * 65536 + 0.5) * _X
_CB_G = -int(0.34414 * 65536 + 0.5) * _X + 32768


def jpeg_refusal(what: str) -> ValueError:
    return ValueError(f"a JPEG image with {what}: only baseline, extended and progressive Huffman-coded 8-bit JPEG "
                      f"is decoded without PIL; the rest is {OTHER_FORMATS_ITEM}")


@functools.lru_cache(maxsize=64)
def _huffman(bits: bytes | tuple, values: bytes | tuple, dc: bool) -> array:
    """A 16-bit lookahead table: entry ``(length << 8) | symbol`` for every
    16-bit window that starts with a code, 0 where none does."""
    if sum(bits) > 256 or len(values) != sum(bits):
        raise ValueError(f"corrupt JPEG: a Huffman table of {sum(bits)} codes for {len(values)} values")
    if dc and any(v > 15 for v in values):
        raise ValueError("corrupt JPEG: a DC Huffman table with a symbol above 15")
    table = np.zeros(1 << 16, np.int32)
    code = n = 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            if code >= 1 << length:
                raise ValueError("corrupt JPEG: a Huffman table whose codes overflow their lengths")
            table[code << (16 - length) : (code + 1) << (16 - length)] = (length << 8) | values[n]
            code += 1
            n += 1
        code <<= 1
    return array("i", table.tobytes())


@dataclass
class _Component:
    ident: int
    h: int
    v: int
    tq: int
    quant: np.ndarray | None = None  # latched at the component's first scan
    coef: array | None = None  # int32 [bh_pad * bw_pad * 64] in natural order
    bw: int = 0  # blocks per row (and rows) the component holds
    bh: int = 0
    bw_pad: int = 0  # padded to whole MCUs
    bh_pad: int = 0


class _Bits:
    """The entropy-coded data of one scan, unstuffed, its restart
    intervals laid end to end: ``win[p]`` is the 32 bits from bit ``p``
    on, ``starts``/``ends`` each interval's first and last bit."""

    def __init__(self, data: np.ndarray, pos: int):
        ff = np.flatnonzero(data[pos:-1] == 0xFF) + pos
        keep = np.ones(len(data), bool)
        cuts, end = [pos], None
        self.markers: list[int] = []
        for i in ff.tolist():
            if not keep[i]:
                continue
            nxt = int(data[i + 1])
            if nxt == 0x00:
                keep[i + 1] = False
            elif 0xD0 <= nxt <= 0xD7:
                keep[i : i + 2] = False
                cuts.append(i)
                self.markers.append(nxt - 0xD0)
            elif nxt == 0xFF:
                keep[i] = False
            else:
                end = i
                break
        if end is None:
            raise ValueError("truncated JPEG: the file ends inside a scan's entropy-coded data")
        self.end = end
        keep[:pos] = False
        keep[end:] = False
        before = np.cumsum(keep) - keep  # kept bytes before each byte
        self.starts = [8 * int(before[c]) for c in cuts]
        self.ends = self.starts[1:] + [8 * int(keep.sum())]
        buf = np.concatenate([data[keep], np.zeros(5, np.uint8)]).astype(np.uint64)
        word = (buf[:-4] << 32) | (buf[1:-3] << 24) | (buf[2:-2] << 16) | (buf[3:-1] << 8) | buf[4:]
        shifts = np.arange(8, 0, -1, dtype=np.uint64)
        self.win = array("I", ((word[:-1, None] >> shifts) & 0xFFFFFFFF).astype(np.uint32).tobytes())


def _scan_blocks(comps: list[_Component], in_scan: list[int], hmax: int, vmax: int, width: int,
                 height: int) -> tuple[list[int], list[int], int]:
    """The scan's blocks in order: (slot in the scan, base offset of the
    block's coefficients) of each, and the blocks of an MCU."""
    if len(in_scan) == 1:
        c = comps[in_scan[0]]
        base = ((np.arange(c.bh)[:, None] * c.bw_pad + np.arange(c.bw)[None, :]) * 64).ravel()
        return [0] * base.size, base.tolist(), 1
    mcux, mcuy = -(-width // (8 * hmax)), -(-height // (8 * vmax))
    slots, bases = [], []
    for slot, ci in enumerate(in_scan):
        c = comps[ci]
        my, mx, y, x = np.meshgrid(np.arange(mcuy), np.arange(mcux), np.arange(c.v), np.arange(c.h), indexing="ij")
        bases.append((((my * c.v + y) * c.bw_pad + mx * c.h + x) * 64).reshape(mcuy * mcux, -1))
        slots.append(np.full_like(bases[-1], slot))
    return np.concatenate(slots, 1).ravel().tolist(), np.concatenate(bases, 1).ravel().tolist(), \
        sum(comps[ci].h * comps[ci].v for ci in in_scan)


def _decode_scan(bits: _Bits, order: tuple[list[int], list[int], int], coefs: list, dc_tabs: list, ac_tabs: list,
                 restart: int, ss: int, se: int, ah: int, al: int, progressive: bool) -> None:
    """Decode one scan's MCUs into the components' coefficients, in the
    JPEG standard's order (libjpeg's ``decode_mcu`` and jdphuff.c's four
    progressive passes)."""
    win = bits.win
    n_int = len(bits.starts)
    interval = 0
    pos = bits.starts[0]
    preds = [0] * len(coefs)
    eobrun = 0
    p1, m1 = 1 << al, -1 << al
    nat = NATURAL
    slots, bases, per_mcu = order
    every = restart * per_mcu
    for i, slot, base in zip(range(len(bases)), slots, bases):
        if every and i and i % every == 0:
            if pos > bits.ends[interval]:
                raise ValueError(f"corrupt JPEG: restart interval {interval} needs more bits than it holds")
            interval += 1
            if interval >= n_int:
                raise ValueError(f"corrupt JPEG: a scan of {len(bases) // per_mcu} MCUs holds {n_int} restart "
                                 f"intervals of {restart}")
            if bits.markers[interval - 1] != (interval - 1) % 8:
                raise ValueError(f"corrupt JPEG: restart marker RST{bits.markers[interval - 1]} where "
                                 f"RST{(interval - 1) % 8} belongs")
            pos = bits.starts[interval]
            preds = [0] * len(coefs)
            eobrun = 0
        coef = coefs[slot]
        if not progressive or (ss == 0 and ah == 0):
            w = win[pos]
            e = dc_tabs[slot][w >> 16]
            if not e:
                raise ValueError(f"corrupt JPEG: a DC Huffman code outside its table at bit {pos}")
            ln, s = e >> 8, e & 255
            if s:
                diff = (w >> (32 - ln - s)) & ((1 << s) - 1)
                if diff < 1 << (s - 1):
                    diff -= (1 << s) - 1
                pos += ln + s
            else:
                diff = 0
                pos += ln
            preds[slot] += diff
            coef[base] = preds[slot] << al if progressive else preds[slot]
            if progressive:
                continue
            actab = ac_tabs[slot]
            k = 1
            while k < 64:
                w = win[pos]
                e = actab[w >> 16]
                if not e:
                    raise ValueError(f"corrupt JPEG: an AC Huffman code outside its table at bit {pos}")
                ln, rs = e >> 8, e & 255
                s = rs & 15
                if s:
                    k += rs >> 4
                    v = (w >> (32 - ln - s)) & ((1 << s) - 1)
                    coef[base + nat[k]] = v - (1 << s) + 1 if v < 1 << (s - 1) else v
                    pos += ln + s
                    k += 1
                elif rs == 0xF0:
                    pos += ln
                    k += 16
                else:
                    pos += ln
                    break
        elif ss == 0:  # DC refinement: one bit
            if win[pos] >> 31:
                coef[base] |= p1
            pos += 1
        elif ah == 0:  # AC first pass
            if eobrun:
                eobrun -= 1
                continue
            actab = ac_tabs[slot]
            k = ss
            while k <= se:
                w = win[pos]
                e = actab[w >> 16]
                if not e:
                    raise ValueError(f"corrupt JPEG: an AC Huffman code outside its table at bit {pos}")
                ln, rs = e >> 8, e & 255
                r, s = rs >> 4, rs & 15
                if s:
                    k += r
                    v = (w >> (32 - ln - s)) & ((1 << s) - 1)
                    coef[base + nat[k]] = (v - (1 << s) + 1 if v < 1 << (s - 1) else v) * p1
                    pos += ln + s
                elif r == 15:
                    pos += ln
                    k += 15
                else:
                    eobrun = (1 << r) - 1
                    if r:
                        eobrun += (w >> (32 - ln - r)) & ((1 << r) - 1)
                    pos += ln + r
                    break
                k += 1
        else:  # AC refinement
            k = ss
            if not eobrun:
                actab = ac_tabs[slot]
                while k <= se:
                    w = win[pos]
                    e = actab[w >> 16]
                    if not e:
                        raise ValueError(f"corrupt JPEG: an AC Huffman code outside its table at bit {pos}")
                    ln, rs = e >> 8, e & 255
                    r, s = rs >> 4, rs & 15
                    pos += ln
                    if s:
                        if s != 1:
                            raise ValueError(f"corrupt JPEG: a refinement coefficient of size {s}")
                        s = p1 if win[pos] >> 31 else m1
                        pos += 1
                    elif r != 15:
                        eobrun = 1 << r
                        if r:
                            eobrun += win[pos] >> (32 - r)
                            pos += r
                        break
                    while k <= se:
                        at = base + nat[k]
                        c = coef[at]
                        if c:
                            if win[pos] >> 31 and not c & p1:
                                coef[at] = c + (p1 if c >= 0 else m1)
                            pos += 1
                        else:
                            if r == 0:
                                break
                            r -= 1
                        k += 1
                    if s:
                        coef[base + nat[k]] = s
                    k += 1
            if eobrun:
                while k <= se:
                    at = base + nat[k]
                    c = coef[at]
                    if c:
                        if win[pos] >> 31 and not c & p1:
                            coef[at] = c + (p1 if c >= 0 else m1)
                        pos += 1
                    k += 1
                eobrun -= 1
    if pos > bits.ends[interval]:
        raise ValueError(f"corrupt JPEG: the scan needs {pos - bits.ends[interval]} bits more than it holds")


def _idct(coef: array, quant: np.ndarray, bh: int, bw: int) -> np.ndarray:
    """``jpeg_idct_islow`` of every block at once: the dequantized
    coefficients through the pass matrix down the columns, descaled by 11
    bits, along the rows, descaled by 18 and range-limited. Float64 holds
    every product and sum exactly. → the plane [bh * 8, bw * 8] uint8."""
    blocks = np.frombuffer(coef, np.int32).reshape(-1, 8, 8) * quant.reshape(8, 8)
    ws = (np.matmul(_IDCT_W, blocks).astype(np.int64) + (1 << 10)) >> 11
    out = (np.matmul(ws.astype(np.float64), _IDCT_W.T).astype(np.int64) + (1 << 17)) >> 18
    pixels = _IDCT_LIMIT[out & 1023]
    return pixels.reshape(bh, bw, 8, 8).transpose(0, 2, 1, 3).reshape(bh * 8, bw * 8)


def _upsample(plane: np.ndarray, hr: int, vr: int) -> np.ndarray:
    """libjpeg-turbo's upsampling of one component by (hr, vr): "fancy"
    triangular h2v1 and h2v2 (for components wider than 2 samples) and
    h1v2, box replication otherwise; the edge rows and columns repeat."""
    p = plane.astype(np.int32)
    h, w = p.shape
    if (hr, vr) == (1, 1):
        return plane
    if (hr, vr) == (1, 2):
        up, down = np.vstack([p[:1], p[:-1]]), np.vstack([p[1:], p[-1:]])
        out = np.empty((2 * h, w), np.int32)
        out[0::2], out[1::2] = (3 * p + up + 1) >> 2, (3 * p + down + 2) >> 2
        return out.astype(np.uint8)
    if (hr, vr) in ((2, 1), (2, 2)) and w > 2:
        if vr == 1:
            rows = [(p, (1, 2))]
        else:
            up, down = np.vstack([p[:1], p[:-1]]), np.vstack([p[1:], p[-1:]])
            rows = [(3 * p + up, (8, 7)), (3 * p + down, (8, 7))]
        out = np.empty((vr * h, 2 * w), np.int32)
        for v, (t, (b0, b1)) in enumerate(rows):
            left, right = np.hstack([t[:, :1], t[:, :-1]]), np.hstack([t[:, 1:], t[:, -1:]])
            shift = 2 if vr == 1 else 4
            out[v::vr, 0::2] = (3 * t + left + b0) >> shift
            out[v::vr, 1::2] = (3 * t + right + b1) >> shift
        return out.astype(np.uint8)
    return np.repeat(np.repeat(plane, vr, axis=0), hr, axis=1)


def _cmyk_to_rgb(cmyk: np.ndarray) -> np.ndarray:
    """PIL's ``convert("RGB")`` of a CMYK image (``cmyk2rgb``)."""
    c = cmyk.astype(np.int32)
    nk = 255 - c[..., 3:]
    t = c[..., :3] * nk + 128
    return np.clip(nk - (((t >> 8) + t) >> 8), 0, 255).astype(np.uint8)


def decode_jpeg(data: bytes) -> np.ndarray:
    """The RGB uint8 image [H, W, 3] of a JPEG file, as PIL's
    ``Image.open(...).convert("RGB")`` gives it on libjpeg-turbo, bit for
    bit: baseline, extended (SOF1) and progressive (SOF2) Huffman coding,
    restart intervals, any integral sampling, grey, YCbCr, RGB, CMYK and
    YCCK (inverted, as PIL reads Adobe files, then PIL's CMYK → RGB). The
    islow IDCT, fancy upsampling and the fixed-point colour tables are
    libjpeg-turbo's; a progressive file is complete before output, so no
    block smoothing applies; EXIF orientation is not applied. A truncated
    or corrupt file raises ``ValueError`` saying what is wrong; arithmetic
    coding, 12-bit samples and lossless JPEG raise, naming ROADMAP item
    16."""
    raw = bytes(data)
    if raw[:2] != JPEG_SOI:
        raise wrong_decoder(raw, "JPEG")
    buf = np.frombuffer(raw + b"\x00", np.uint8)
    pos = 2
    qt: dict[int, np.ndarray] = {}
    dc_t: dict[int, list] = {}
    ac_t: dict[int, list] = {}
    comps: list[_Component] = []
    frame = None
    restart = 0
    jfif = adobe = False
    transform = None
    seen_scan = False
    while True:
        while pos < len(raw) and raw[pos] == 0xFF and pos + 1 < len(raw) and raw[pos + 1] == 0xFF:
            pos += 1  # fill bytes before a marker
        if pos + 2 > len(raw):
            raise ValueError(f"truncated JPEG: the file ends at byte {len(raw)} before EOI")
        if raw[pos] != 0xFF:
            raise ValueError(f"corrupt JPEG: byte {pos} is 0x{raw[pos]:02x}, not a marker")
        marker = raw[pos + 1]
        pos += 2
        if marker == 0xD9:
            break
        if 0xD0 <= marker <= 0xD7 or marker in (0x01, 0xD8):
            raise ValueError(f"corrupt JPEG: marker 0x{marker:02x} outside a scan at byte {pos - 2}")
        if pos + 2 > len(raw):
            raise ValueError(f"truncated JPEG: the file ends inside marker 0x{marker:02x}'s length")
        (length,) = struct.unpack(">H", raw[pos : pos + 2])
        seg = raw[pos + 2 : pos + length]
        if length < 2 or pos + length > len(raw):
            raise ValueError(f"truncated JPEG: marker 0x{marker:02x} of {length} bytes at byte {pos - 2} runs past "
                             f"the file's {len(raw)} bytes")
        pos += length
        if marker in (0xC0, 0xC1, 0xC2):
            if frame is not None:
                raise ValueError("corrupt JPEG: a second frame header")
            if len(seg) < 6:
                raise ValueError("corrupt JPEG: a short frame header")
            precision, height, width, nf = struct.unpack(">BHHB", seg[:6])
            if precision != 8:
                raise jpeg_refusal(f"{precision}-bit samples")
            if not height or not width:
                raise jpeg_refusal(f"a {width}x{height} frame (a DNL marker)") if not height else \
                    ValueError("corrupt JPEG: a frame of width 0")
            if nf not in (1, 3, 4) or len(seg) < 6 + 3 * nf:
                raise ValueError(f"corrupt JPEG: a frame of {nf} components" if nf in (1, 3, 4) else
                                 f"a JPEG image of {nf} components, which PIL does not open either")
            for i in range(nf):
                ident, hv, tq = seg[6 + 3 * i : 9 + 3 * i]
                h, v = hv >> 4, hv & 15
                if not (1 <= h <= 4 and 1 <= v <= 4) or tq > 3:
                    raise ValueError(f"corrupt JPEG: component {ident} sampling {h}x{v}, table {tq}")
                comps.append(_Component(ident, h, v, tq))
            frame = (marker == 0xC2, height, width)
        elif 0xC3 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            kinds = {0xC3: "lossless coding (SOF3)", 0xC5: "differential coding", 0xC6: "differential coding",
                     0xC7: "differential lossless coding"}
            raise jpeg_refusal(kinds.get(marker, f"arithmetic coding (SOF{marker - 0xC0})"))
        elif marker == 0xCC:
            raise jpeg_refusal("arithmetic coding (a DAC marker)")
        elif marker == 0xC4:
            i = 0
            while i < len(seg):
                if i + 17 > len(seg):
                    raise ValueError("corrupt JPEG: a short Huffman table")
                tc, th = seg[i] >> 4, seg[i] & 15
                counts = seg[i + 1 : i + 17]
                values = seg[i + 17 : i + 17 + sum(counts)]
                if tc > 1 or th > 3 or len(values) < sum(counts):
                    raise ValueError(f"corrupt JPEG: Huffman table class {tc} id {th} of {sum(counts)} values")
                (ac_t if tc else dc_t)[th] = _huffman(bytes(counts), bytes(values), dc=not tc)
                i += 17 + sum(counts)
        elif marker == 0xDB:
            i = 0
            while i < len(seg):
                pq, tq = seg[i] >> 4, seg[i] & 15
                n = 128 if pq else 64
                if pq > 1 or tq > 3 or i + 1 + n > len(seg):
                    raise ValueError(f"corrupt JPEG: quantization table {tq} of precision {pq}")
                zz = np.frombuffer(seg[i + 1 : i + 1 + n], ">u2" if pq else np.uint8).astype(np.float64)
                table = np.zeros(64)
                table[_ZIGZAG] = zz
                qt[tq] = table
                i += 1 + n
        elif marker == 0xDD:
            if len(seg) < 2:
                raise ValueError("corrupt JPEG: a short restart interval")
            (restart,) = struct.unpack(">H", seg[:2])
        elif marker == 0xE0:
            jfif = jfif or (len(seg) >= 14 and seg[:5] == b"JFIF\x00")
        elif marker == 0xEE:
            if len(seg) >= 12 and seg[:5] == b"Adobe":
                adobe, transform = True, seg[11]
        elif marker == 0xDC:
            raise jpeg_refusal("a DNL marker")
        elif marker == 0xDA:
            if frame is None:
                raise ValueError("corrupt JPEG: a scan before the frame header")
            progressive, height, width = frame
            hmax, vmax = max(c.h for c in comps), max(c.v for c in comps)
            if not seen_scan:
                mcux, mcuy = -(-width // (8 * hmax)), -(-height // (8 * vmax))
                for c in comps:
                    c.bw = -(-(-(-width * c.h // hmax)) // 8)
                    c.bh = -(-(-(-height * c.v // vmax)) // 8)
                    c.bw_pad, c.bh_pad = mcux * c.h, mcuy * c.v
                    c.coef = array("i", bytes(4 * c.bw_pad * c.bh_pad * 64))
                seen_scan = True
            ns = seg[0] if seg else 0
            if not 1 <= ns <= 4 or len(seg) < 4 + 2 * ns:
                raise ValueError(f"corrupt JPEG: a scan of {ns} components")
            ids = {c.ident: i for i, c in enumerate(comps)}
            in_scan, dcs, acs = [], [], []
            for j in range(ns):
                cs, t = seg[1 + 2 * j : 3 + 2 * j]
                if cs not in ids:
                    raise ValueError(f"corrupt JPEG: a scan names component {cs}, which the frame lacks")
                in_scan.append(ids[cs])
                dcs.append(t >> 4)
                acs.append(t & 15)
            ss, se, a = seg[1 + 2 * ns : 4 + 2 * ns]
            ah, al = a >> 4, a & 15
            if progressive:
                bad = (ss > se or se > 63 or (ss == 0 and se != 0) or (ss and ns != 1) or al > 13
                       or (ah and ah != al + 1))
            else:
                bad = ss != 0 or se != 63 or ah or al
            if bad:
                raise ValueError(f"corrupt JPEG: a scan with Ss {ss}, Se {se}, Ah {ah}, Al {al}")
            if len(in_scan) > 1 and sum(comps[i].h * comps[i].v for i in in_scan) > 10:
                raise ValueError("corrupt JPEG: an MCU of more than 10 blocks")
            for i in in_scan:
                if comps[i].quant is None:
                    if comps[i].tq not in qt:
                        raise ValueError(f"corrupt JPEG: quantization table {comps[i].tq} is not defined")
                    comps[i].quant = qt[comps[i].tq]

            def table(tables, cls, t):
                if t in tables:
                    return tables[t]
                if (cls, t) in STD_HUFFMAN:
                    return _huffman(*map(bytes, STD_HUFFMAN[cls, t]), dc=not cls)
                raise ValueError(f"corrupt JPEG: Huffman table {t} is not defined")

            need_dc = not progressive or (ss == 0 and ah == 0)
            need_ac = not progressive or ss > 0
            dc_tabs = [table(dc_t, 0, t) if need_dc else None for t in dcs]
            ac_tabs = [table(ac_t, 1, t) if need_ac else None for t in acs]
            bits = _Bits(buf, pos)
            order = _scan_blocks(comps, in_scan, hmax, vmax, width, height)
            _decode_scan(bits, order, [comps[i].coef for i in in_scan], dc_tabs, ac_tabs, restart,
                         ss, se, ah, al, progressive)
            pos = bits.end
        # APPn, COM and other segments carry nothing the decode needs
    if not seen_scan:
        raise ValueError("corrupt JPEG: no scan before EOI")
    _, height, width = frame
    hmax, vmax = max(c.h for c in comps), max(c.v for c in comps)
    planes = []
    for c in comps:
        if hmax % c.h or vmax % c.v:
            raise ValueError(f"a JPEG image with fractional sampling ({c.h}x{c.v} of {hmax}x{vmax}), which "
                             "libjpeg does not decode either")
        if c.quant is None:
            raise ValueError(f"corrupt JPEG: component {c.ident} is in no scan")
        plane = _idct(c.coef, c.quant, c.bh_pad, c.bw_pad)
        plane = plane[: -(-height * c.v // vmax), : -(-width * c.h // hmax)]
        planes.append(_upsample(plane, hmax // c.h, vmax // c.v)[:height, :width])
    if len(comps) == 1:
        return np.repeat(planes[0][..., None], 3, axis=2)
    if len(comps) == 3:
        if jfif:
            ycc = True
        elif adobe:
            ycc = transform != 0
        else:
            ycc = [c.ident for c in comps] != [82, 71, 66]
        if not ycc:
            return np.stack(planes, axis=-1)
        y, cb, cr = (p.astype(np.int64) for p in planes)
        rgb = np.stack([y + _CR_R[cr], y + ((_CB_G[cb] + _CR_G[cr]) >> 16), y + _CB_B[cb]], axis=-1)
        return np.clip(rgb, 0, 255).astype(np.uint8)
    if adobe and transform != 0:  # YCCK → CMYK (jdcolor.c ycck_cmyk_convert)
        y, cb, cr = (p.astype(np.int64) for p in planes[:3])
        cmy = 255 - np.clip(np.stack([y + _CR_R[cr], y + ((_CB_G[cb] + _CR_G[cr]) >> 16), y + _CB_B[cb]], -1), 0, 255)
        cmyk = np.concatenate([cmy, planes[3][..., None]], axis=-1)
    else:
        cmyk = np.stack(planes, axis=-1)
    return _cmyk_to_rgb(255 - cmyk.astype(np.int32))


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
