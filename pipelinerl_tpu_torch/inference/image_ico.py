"""ICO and CUR decoding on numpy and the stdlib: what ``PIL.Image.open(...)
.convert("RGB")`` gives, bit for bit, for what Pillow's ``IcoImagePlugin``
and ``CurImagePlugin`` read.

- ICO: the entry Pillow loads is the first after sorting the directory by
  colour depth and then, stably, by area, largest first: the largest icon,
  and of those the shallowest. An entry that starts with the PNG signature
  is a PNG (``decode_png``); any other is a DIB, a BMP without its file
  header whose height counts the XOR image and the AND mask, read by
  ``image_bmp.decode_bmp`` at half that height. The AND mask (or, for a
  32-bit entry, the fourth byte of each pixel) becomes alpha, which
  ``convert("RGB")`` drops; Pillow still reads it, and a mask that runs
  past the file's end fails the image, here too.
- CUR: the first entry, or a later one both wider and taller than it, as
  a DIB the same way (no mask read; a PNG entry fails, as in Pillow).

A directory with no entries is not an ICO (or CUR) to Pillow, which goes
on to its other plugins; ``Declined`` says so. No torch: the host-only
actor runs it.
"""

from __future__ import annotations

import math
import struct

import numpy as np

from .image_bmp import decode_bmp
from .image_pipeline import PNG_SIGNATURE, Declined, decode_png

_DIB_HEADERS = (12, 40, 52, 56, 64, 108, 124)


def _dib(data: bytes, offset: int) -> tuple[np.ndarray, int, int, int]:
    """The XOR image of the DIB at ``offset`` (its header's height halved),
    through ``decode_bmp`` on the same bytes behind a BMP file header; →
    (RGB, width, half height, the pixels' offset)."""
    if offset + 4 > len(data):
        raise ValueError(f"truncated icon: its bitmap at byte {offset} runs past the file's end")
    (hsize,) = struct.unpack_from("<I", data, offset)
    if hsize not in _DIB_HEADERS:
        raise ValueError(f"an icon whose bitmap has a {hsize}-byte header, which PIL does not open either")
    if offset + hsize > len(data):
        raise ValueError(f"truncated icon: the bitmap's {hsize}-byte header runs past the file's end")
    dib = bytearray(data[offset:])
    if hsize == 12:
        w, h, _, bits = struct.unpack_from("<HHHH", dib, 4)
        compression, colors, entry, half = 0, 0, 3, h // 2
        struct.pack_into("<H", dib, 6, half)
    else:
        w, h, _, bits, compression = struct.unpack_from("<IIHHI", dib, 4)
        colors, entry = struct.unpack_from("<I", dib, 32)[0], 4
        if dib[11] == 0xFF:  # top-down
            half = (2**32 - h) // 2
            struct.pack_into("<I", dib, 8, (2**32 - half) % 2**32)
        else:
            half = h // 2
            struct.pack_into("<I", dib, 8, half)
    pixels = hsize + (12 if compression == 3 and hsize == 40 else 0)
    if bits <= 8:
        pixels += entry * (colors or 1 << bits)
    bmp = b"BM" + struct.pack("<IHHI", 14 + len(dib), 0, 0, 14 + pixels) + bytes(dib)
    return decode_bmp(bmp), w, half, offset + pixels


def decode_ico(data: bytes) -> np.ndarray:
    """The RGB uint8 image [H, W, 3] of an ICO file, as PIL's
    ``Image.open(...).convert("RGB")`` gives it; a truncated or corrupt
    file raises ``ValueError`` saying what is wrong."""
    data = bytes(data)
    if data[:4] != b"\0\0\1\0":
        raise Declined("not an ICO file")
    (count,) = struct.unpack_from("<H", data, 4) if len(data) >= 6 else (0,)
    if count == 0 or 6 + 16 * count > len(data):
        raise Declined("an ICO directory with no entries, or cut short")
    entries = []
    for i in range(count):
        s = data[6 + 16 * i : 22 + 16 * i]
        w, h, nb_color = s[0] or 256, s[1] or 256, s[2]
        bpp, size, offset = struct.unpack_from("<HII", s, 6)
        depth = bpp or (nb_color != 0 and math.ceil(math.log(nb_color, 2))) or 256
        entries.append((w * h, depth, bpp, size, offset))
    entries.sort(key=lambda e: e[1])
    entries.sort(key=lambda e: e[0], reverse=True)
    _, _, bpp, size, offset = entries[0]
    if data[offset : offset + 8] == PNG_SIGNATURE:
        return decode_png(data[offset:])
    rgb, w, h, pixels = _dib(data, offset)
    if bpp == 32:
        if pixels + 4 * w * h > len(data):
            raise ValueError("truncated ICO: a 32-bit entry's alpha runs past the file's end")
    else:
        stride = (w + 31) // 32 * 4
        start = offset + size - stride * h
        if start < 0 or start + stride * h > len(data):
            raise ValueError(f"truncated ICO: the AND mask of {stride * h} bytes at byte {start} lies outside the "
                             f"file's {len(data)} bytes")
    return rgb


def decode_cur(data: bytes) -> np.ndarray:
    """The RGB uint8 image [H, W, 3] of a CUR file, as PIL's
    ``Image.open(...).convert("RGB")`` gives it; a truncated or corrupt
    file raises ``ValueError`` saying what is wrong."""
    data = bytes(data)
    if data[:4] != b"\0\0\2\0":
        raise Declined("not a CUR file")
    (count,) = struct.unpack_from("<H", data, 4) if len(data) >= 6 else (0,)
    best = None
    for i in range(count):
        s = data[6 + 16 * i : 22 + 16 * i]
        if len(s) < 16:
            raise Declined("a CUR directory cut short")
        if best is None or (s[0] > best[0] and s[1] > best[1]):
            best = s
    if best is None:
        raise Declined("a CUR file with no cursors")
    (offset,) = struct.unpack_from("<I", best, 12)
    return _dib(data, offset or 6 + 16 * count)[0]
