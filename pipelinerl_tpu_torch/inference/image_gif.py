"""GIF decoding on numpy and the stdlib: what ``PIL.Image.open(...)
.convert("RGB")`` gives, bit for bit.

Only the first frame is read (GIF87a and GIF89a; global and local colour
tables; interlaced images), as Pillow reads it: the logical screen grows
to hold the first image descriptor, the pixels outside the descriptor are
the transparency index when the graphic control extension sets one and 0
otherwise, and the frame's palette (its local table, else the global one)
maps the indices to RGB, entries past the table black. A table that is the
identity grey ramp counts as none: Pillow opens the image as "L", where an
index is its own grey, unless a global table stands behind a grey local
one, which then applies. The transparency index is otherwise ignored, as
``convert("RGB")`` ignores it. No torch: the host-only actor runs it.
"""

from __future__ import annotations

import numpy as np

from .image_lzw import lzw_decode


def _table(data: bytes, pos: int, bits: int) -> tuple[np.ndarray | None, int]:
    """A colour table of ``1 << bits`` entries at ``pos`` → (its RGB
    [N, 3], or None where it is the identity grey ramp; the position past
    it)."""
    size = 3 << bits
    if pos + size > len(data):
        raise ValueError(f"truncated GIF: a colour table of {size} bytes at byte {pos} runs past the file's end")
    table = np.frombuffer(data, np.uint8, size, pos).reshape(-1, 3)
    grey = (table == np.arange(len(table))[:, None]).all()
    return (None if grey else table), pos + size


def _sub_blocks(data: bytes, pos: int) -> tuple[bytes, int]:
    """The data sub-blocks from ``pos`` → (their bytes, the position past
    the terminator); a sub-block cut by the file's end is dropped, as
    Pillow waits for a whole block."""
    parts = []
    while pos < len(data):
        size = data[pos]
        if size == 0:
            return b"".join(parts), pos + 1
        if pos + 1 + size > len(data):
            break
        parts.append(data[pos + 1 : pos + 1 + size])
        pos += 1 + size
    return b"".join(parts), len(data)


def _interlaced_rows(h: int) -> np.ndarray:
    return np.concatenate([np.arange(0, h, 8), np.arange(4, h, 8), np.arange(2, h, 4), np.arange(1, h, 2)])


def decode_gif(data: bytes) -> np.ndarray:
    """The RGB uint8 image [H, W, 3] of a GIF file's first frame, as PIL's
    ``Image.open(...).convert("RGB")`` gives it; a truncated or corrupt
    file raises ``ValueError`` saying what is wrong."""
    data = bytes(data)
    if len(data) < 13 or data[:6] not in (b"GIF87a", b"GIF89a"):
        raise ValueError("not a GIF file: no GIF87a or GIF89a header")
    sw, sh = int.from_bytes(data[6:8], "little"), int.from_bytes(data[8:10], "little")
    flags = data[10]
    pos = 13
    global_table = None
    if flags & 0x80:
        global_table, pos = _table(data, pos, (flags & 7) + 1)
    transparency = None
    while True:
        if pos >= len(data):
            raise ValueError("truncated GIF: the file ends before its first image")
        kind = data[pos]
        if kind == 0x3B:
            raise ValueError("corrupt GIF: the trailer comes before any image")
        if kind == 0x21:
            if pos + 2 > len(data):
                raise ValueError("truncated GIF: the file ends inside an extension")
            label = data[pos + 1]
            block, pos = _sub_blocks(data, pos + 2)
            if label == 0xF9 and block:
                if len(block) < 4:
                    raise ValueError(f"corrupt GIF: a graphic control extension of {len(block)} bytes")
                transparency = block[3] if block[0] & 1 else None
            continue
        if kind != 0x2C:
            raise ValueError(f"corrupt GIF: block type 0x{kind:02x} at byte {pos}")
        if pos + 11 > len(data):
            raise ValueError("truncated GIF: the file ends inside an image descriptor")
        x0, y0, w, h = (int.from_bytes(data[pos + 1 + 2 * i : pos + 3 + 2 * i], "little") for i in range(4))
        iflags = data[pos + 9]
        pos += 10
        local = False
        if iflags & 0x80:
            local = True
            local_table, pos = _table(data, pos, (iflags & 7) + 1)
        if pos >= len(data):
            raise ValueError("truncated GIF: the file ends before the image's LZW code size")
        min_bits = data[pos]
        if min_bits > 12:
            raise ValueError(f"corrupt GIF: an LZW code size of {min_bits} bits (12 at most)")
        stream, pos = _sub_blocks(data, pos + 1)
        break
    width, height = max(sw, x0 + w), max(sh, y0 + h)
    if not width or not height or not w or not h:
        raise ValueError(f"corrupt GIF: a {w}x{h} image on a {width}x{height} screen")
    pixels, _ = lzw_decode(stream, min_bits, w * h, tiff=False, what="GIF")
    if len(pixels) < w * h:  # Pillow waits for more data after an early end code too
        raise ValueError(f"truncated GIF: the image data ends after {len(pixels)} of its {w * h} pixels")
    canvas = np.full((height, width), 0 if transparency is None else transparency, np.uint8)
    region = canvas[y0 : y0 + h, x0 : x0 + w]
    rows = np.frombuffer(bytes(pixels), np.uint8).reshape(h, w)
    if iflags & 0x40:
        region[_interlaced_rows(h)] = rows
    else:
        region[:] = rows
    # a local grey ramp leaves Pillow the global table, which it then applies
    table = local_table if local and local_table is not None else global_table
    if table is None:
        return np.repeat(canvas[..., None], 3, axis=2)
    palette = np.zeros((256, 3), np.uint8)  # entries past the table read black
    palette[: len(table)] = table
    return palette[canvas]
