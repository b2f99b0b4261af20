"""SGI image decoding on numpy and the stdlib: what ``PIL.Image.open(...)
.convert("RGB")`` gives, bit for bit, for what Pillow's ``SgiImagePlugin``
reads.

- 1 or 2 bytes a sample (16-bit samples read by their high byte, as
  Pillow's ``;16B`` unpackers read them); 1 channel (grey, dimension 1 or
  2), 3 (RGB) or 4 (RGBA, alpha dropped by ``convert("RGB")``), dimension
  3; rows bottom-up.
- Verbatim: each channel's plane in turn after the 512-byte header.
- RLE: the tables of each row's offset and length (rows of channel 0
  first), then each row's packets: a count byte (a count word at 16 bits)
  whose top bit copies that many samples, else repeats the next one, 0
  ending the row. A row that runs past the width or the file fails the
  image, as in Pillow.

Other layouts raise, as Pillow raises. No torch: the host-only actor runs
it.
"""

from __future__ import annotations

import struct

import numpy as np

_CHANNELS = {(1, 1): 1, (2, 1): 1, (3, 3): 3, (3, 4): 4}  # (dimension, zsize) → channels


def _rle_row(data: bytes, start: int, length: int, width: int, bpc: int) -> np.ndarray:
    """One channel's row of SGI RLE: ``length`` bytes at ``start``."""
    if start + length > len(data):
        raise ValueError(f"truncated SGI: a row's {length} RLE bytes at byte {start} run past the file's end")
    words = np.frombuffer(data, np.uint8 if bpc == 1 else ">u2", length // bpc, start)
    out = np.zeros(width, np.int64)
    x, i = 0, 0
    while i < len(words):
        count = int(words[i]) & 0x7F
        if not count:
            break
        if x + count > width:
            raise ValueError("corrupt SGI: an RLE row runs past the image's width")
        if words[i] & 0x80:
            if i + 1 + count > len(words):
                raise ValueError("corrupt SGI: an RLE copy runs past its row's data")
            out[x : x + count] = words[i + 1 : i + 1 + count]
            i += 1 + count
        else:
            if i + 1 >= len(words):
                raise ValueError("corrupt SGI: an RLE run runs past its row's data")
            out[x : x + count] = words[i + 1]
            i += 2
        x += count
    return out


def decode_sgi(data: bytes) -> np.ndarray:
    """The RGB uint8 image [H, W, 3] of an SGI file, as PIL's
    ``Image.open(...).convert("RGB")`` gives it; a truncated or corrupt
    file raises ``ValueError`` saying what is wrong."""
    data = bytes(data)
    if len(data) < 512 or data[:2] != b"\x01\xda":
        raise ValueError("not an SGI file, or its 512-byte header is cut short")
    compression, bpc = data[2], data[3]
    dimension, w, h, z = struct.unpack_from(">HHHH", data, 4)
    channels = _CHANNELS.get((dimension, z))
    if channels is None or bpc not in (1, 2):
        raise ValueError(f"an SGI image of {bpc} byte(s) a sample, dimension {dimension} and {z} channel(s), which "
                         "PIL does not open either")
    if compression == 0:
        size = w * h * bpc
        if 512 + size * channels > len(data):
            raise ValueError(f"truncated SGI: {channels} planes of {size} bytes run past the file's end")
        planes = np.frombuffer(data, np.uint8 if bpc == 1 else ">u2", w * h * channels, 512).reshape(channels, h, w)
    elif compression == 1:
        n = h * channels
        if 512 + 8 * n > len(data):
            raise ValueError("truncated SGI: the RLE offset tables run past the file's end")
        starts = np.frombuffer(data, ">u4", n, 512)
        lengths = np.frombuffer(data, ">u4", n, 512 + 4 * n)
        planes = np.stack([np.stack([_rle_row(data, int(starts[c * h + y]), int(lengths[c * h + y]), w, bpc)
                                     for y in range(h)]) for c in range(channels)])
    else:
        raise ValueError(f"an SGI image of compression {compression}, which PIL does not decode either")
    if bpc == 2:
        planes = planes >> 8
    rgb = planes[:3] if channels >= 3 else np.repeat(planes, 3, axis=0)
    return np.ascontiguousarray(np.moveaxis(rgb, 0, -1)[::-1].astype(np.uint8))
