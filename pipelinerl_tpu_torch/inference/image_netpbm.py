"""Netpbm decoding on numpy and the stdlib: what ``PIL.Image.open(...)
.convert("RGB")`` gives, bit for bit, for what Pillow's ``PpmImagePlugin``
reads.

- P1-P6: plain (ASCII) and raw bitmaps, greymaps and pixmaps. The header's
  tokens are read as Pillow reads them, one byte at a time: whitespace
  ends a token, ``#`` skips to the end of its line and the token goes on
  after it, a token is at most 10 bytes, and exactly one whitespace byte
  ends the last one before raw samples. ``maxval`` runs 1-65,535: 255
  reads bytes as they are, a greymap of 65,535 reads 16-bit samples as
  they are ("I", clipped at 255 by ``convert("RGB")``), any other scales
  each sample to 8 bits (16 bits for a greymap over 255) with Python's
  ``round(v / maxval * out_max)``. In the plain formats a comment runs
  from ``#`` to the nearest CR or LF, which goes with it, so the text on
  both sides joins.
- Pillow's own ``P0CMYK``, ``PyCMYK`` (converted as ``cmyk2rgb``),
  ``PyRGBA`` and ``PyP`` (no palette: black), read the same way.
- ``Pf``: the grey PFM, float32 samples (little-endian where the scale is
  negative), rows bottom-up, the scale otherwise unused; ``convert("RGB")``
  clips to [0, 255] and truncates. Pillow 12 does not open the colour
  ``PF``, nor PAM (``P7``); both raise here too.

No torch: the host-only actor runs it.
"""

from __future__ import annotations

import math

import numpy as np

from .image_pipeline import Declined

_WHITESPACE = b"\x20\x09\x0a\x0b\x0c\x0d"
_MODES = {b"P1": "1", b"P2": "L", b"P3": "RGB", b"P4": "1", b"P5": "L", b"P6": "RGB", b"Pf": "F", b"P0CMYK": "CMYK",
          b"PyP": "P", b"PyRGBA": "RGBA", b"PyCMYK": "CMYK"}
_BANDS = {"L": 1, "P": 1, "RGB": 3, "RGBA": 4, "CMYK": 4}


def _header(data: bytes) -> tuple[bytes, list[bytes], int]:
    """(the magic, the header's tokens, the position past them)."""
    pos, magic = 0, b""
    for _ in range(6):  # up to a whitespace byte, which goes with it, or 6 bytes
        if pos >= len(data):
            break
        pos += 1
        if data[pos - 1] in _WHITESPACE:
            break
        magic += data[pos - 1 : pos]
    if magic not in _MODES:
        raise Declined("not a PPM file")
    mode = _MODES[magic]
    tokens = []
    for _ in range(2 if mode == "1" else 3):
        token = b""
        while len(token) <= 10:
            if pos >= len(data):
                break
            c = data[pos : pos + 1]
            pos += 1
            if c in _WHITESPACE:
                if not token:
                    continue
                break
            if c == b"#":
                while pos < len(data) and data[pos] not in b"\r\n":
                    pos += 1
                pos += 1  # the CR or LF (or nothing at the end)
                continue
            token += c
        if not token:
            raise ValueError("truncated Netpbm file: the end came while reading the header")
        if len(token) > 10:
            raise ValueError(f"corrupt Netpbm file: a header token longer than 10 bytes ({token[:11]!r})")
        tokens.append(token)
    return magic, tokens, pos


def _strip_comments(block: bytes) -> bytes:
    """Pillow's ``PpmPlainDecoder._ignore_comments`` on one block: each
    ``#`` up to and with the nearest CR or LF deleted, the text around it
    joined; a comment to the end deleted to the end."""
    while True:
        start = block.find(b"#")
        if start < 0:
            return block
        a, b = block.find(b"\n", start), block.find(b"\r", start)
        end = min(a, b) if a * b > 0 else max(a, b)
        if end < 0:
            return block[:start]
        block = block[:start] + block[end + 1 :]


def _plain_values(body: bytes, n: int, maxval: int, out_max: int) -> np.ndarray:
    """The first ``n`` samples of a P2/P3 body, scaled as Pillow scales
    them."""
    tokens = _strip_comments(body).split()
    if any(len(t) > 10 for t in tokens[:n]):
        raise ValueError("corrupt Netpbm file: a sample token longer than 10 bytes")
    values = [int(t) for t in tokens[:n]]
    if len(values) < n:
        raise ValueError(f"truncated Netpbm file: {len(values)} of its {n} samples")
    if min(values) < 0 or max(values) > maxval:
        raise ValueError(f"corrupt Netpbm file: a sample outside [0, maxval {maxval}]")
    return np.asarray([round(v / maxval * out_max) for v in values], np.int64)


def decode_netpbm(data: bytes) -> np.ndarray:
    """The RGB uint8 image [H, W, 3] of a PBM, PGM, PPM (plain or raw) or
    grey PFM file, as PIL's ``Image.open(...).convert("RGB")`` gives it; a
    truncated or corrupt file raises ``ValueError`` saying what is wrong."""
    data = bytes(data)
    magic, tokens, pos = _header(data)
    mode = _MODES[magic]
    w, h = int(tokens[0]), int(tokens[1])
    if w <= 0 or h <= 0:
        raise ValueError(f"corrupt Netpbm file: a {w}x{h} image")
    if mode == "1":
        if magic == b"P1":
            bits = b"".join(_strip_comments(data[pos:]).split())
            if bits.translate(None, b"01"):
                raise ValueError(f"corrupt PBM: a sample byte {bits.translate(None, b'01')[:1]!r} (only 0 and 1)")
            if len(bits) < w * h:
                raise ValueError(f"truncated PBM: {len(bits)} of its {w * h} samples")
            ink = np.frombuffer(bits[: w * h], np.uint8).reshape(h, w) == ord("1")
        else:
            stride = (w + 7) // 8
            if pos + stride * h > len(data):
                raise ValueError(f"truncated PBM: {h} rows of {stride} bytes from byte {pos}")
            rows = np.frombuffer(data, np.uint8, stride * h, pos).reshape(h, stride)
            ink = np.unpackbits(rows, axis=1)[:, :w].astype(bool)
        grey = np.where(ink, 0, 255).astype(np.uint8)
        return np.repeat(grey[..., None], 3, axis=2)
    if mode == "F":
        scale = float(tokens[2])
        if scale == 0.0 or not math.isfinite(scale):
            raise ValueError("corrupt PFM: the scale must be finite and non-zero")
        if pos + 4 * w * h > len(data):
            raise ValueError(f"truncated PFM: {w * h} float samples from byte {pos}")
        f = np.frombuffer(data, "<f4" if scale < 0 else ">f4", w * h, pos).reshape(h, w)[::-1].astype(np.float32)
        with np.errstate(invalid="ignore"):
            grey = np.where(f >= 255, 255, np.where(f > 0, np.trunc(np.nan_to_num(f)), 0)).astype(np.uint8)
        return np.repeat(grey[..., None], 3, axis=2)
    maxval = int(tokens[2])
    if not 0 < maxval < 65536:
        raise ValueError("corrupt Netpbm file: maxval must be greater than 0 and less than 65536")
    bands = _BANDS[mode]
    wide = mode == "L" and maxval > 255  # Pillow's mode "I", 16-bit samples
    out_max = 65535 if wide else 255
    n = w * h * bands
    if magic in (b"P2", b"P3"):
        values = _plain_values(data[pos:], n, maxval, out_max)
    else:
        size = 1 if maxval < 256 else 2
        if pos + size * n > len(data):
            raise ValueError(f"truncated Netpbm file: {n} samples of {size} byte(s) from byte {pos}")
        values = np.frombuffer(data, np.uint8 if size == 1 else ">u2", n, pos).astype(np.int64)
        if maxval not in (255, 65535) or (maxval == 65535 and mode != "L"):
            values = np.minimum(out_max, np.round(values / maxval * out_max)).astype(np.int64)
    values = np.minimum(values, 255).reshape(h, w, bands)
    if mode == "CMYK":  # PIL's cmyk2rgb
        nk = 255 - values[..., 3:]
        t = values[..., :3] * nk + 128
        values = np.clip(nk - (((t >> 8) + t) >> 8), 0, 255)
    elif mode == "P":  # no palette: black, as PIL converts it
        values = np.zeros_like(values)
    values = values.astype(np.uint8)
    return np.repeat(values, 3, axis=2) if bands == 1 else np.ascontiguousarray(values[..., :3])
