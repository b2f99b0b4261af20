"""QOI decoding on the stdlib and numpy: what ``PIL.Image.open(...)
.convert("RGB")`` gives, bit for bit, for what Pillow's ``QoiImagePlugin``
reads.

The ops as Pillow's decoder runs them: ``QOI_OP_RGB`` keeps the previous
alpha, ``QOI_OP_INDEX`` of a slot never written reads (0, 0, 0, 0), a run
repeats the previous pixel and leaves the index as it is, every other op
writes its pixel into slot ``(3r + 5g + 7b + 11a) % 64``; the first pixel's
predecessor is (0, 0, 0, 255). A channels byte of 3 gives RGB, any other
RGBA (alpha dropped by ``convert("RGB")``); the colour-space byte is
ignored. One pass over the ops in Python: QOI's ops each depend on the
pixel before. No torch: the host-only actor runs it.
"""

from __future__ import annotations

import struct

import numpy as np


def decode_qoi(data: bytes) -> np.ndarray:
    """The RGB uint8 image [H, W, 3] of a QOI file, as PIL's
    ``Image.open(...).convert("RGB")`` gives it; a truncated file raises
    ``ValueError``."""
    data = bytes(data)
    if data[:4] != b"qoif" or len(data) < 14:
        raise ValueError("not a QOI file, or its header is cut short")
    w, h = struct.unpack_from(">II", data, 4)
    need = w * h
    out = bytearray(4 * need)
    seen = [b"\0\0\0\0"] * 64
    r, g, b, a = 0, 0, 0, 255
    pos, n, end = 14, 0, len(data)
    try:
        while n < need:
            op = data[pos]
            pos += 1
            if op == 0xFE:
                r, g, b = data[pos], data[pos + 1], data[pos + 2]
                pos += 3
            elif op == 0xFF:
                r, g, b, a = data[pos], data[pos + 1], data[pos + 2], data[pos + 3]
                pos += 4
            elif op >> 6 == 0:
                r, g, b, a = seen[op]
            elif op >> 6 == 1:
                r, g, b = (r + (op >> 4 & 3) - 2) % 256, (g + (op >> 2 & 3) - 2) % 256, (b + (op & 3) - 2) % 256
            elif op >> 6 == 2:
                second = data[pos]
                pos += 1
                dg = (op & 0x3F) - 32
                r, g, b = (r + dg + (second >> 4) - 8) % 256, (g + dg) % 256, (b + dg + (second & 15) - 8) % 256
            else:
                run = min((op & 0x3F) + 1, need - n)
                out[4 * n : 4 * (n + run)] = bytes((r, g, b, a)) * run
                n += run
                continue
            pixel = bytes((r, g, b, a))
            seen[(r * 3 + g * 5 + b * 7 + a * 11) % 64] = pixel
            out[4 * n : 4 * n + 4] = pixel
            n += 1
    except IndexError:
        raise ValueError(f"truncated QOI: the file ends at byte {end} after {n} of its {need} pixels") from None
    return np.frombuffer(bytes(out), np.uint8).reshape(h, w, 4)[..., :3].copy()
