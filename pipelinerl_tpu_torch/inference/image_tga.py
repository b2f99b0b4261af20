"""TGA decoding on numpy and the stdlib: what ``PIL.Image.open(...)
.convert("RGB")`` gives, bit for bit, for what Pillow's ``TgaImagePlugin``
reads.

- Image types 1 (colour-mapped), 2 (true colour) and 3 (grey), raw, and
  9-11, their RLE forms: true colour at 16 bits (5-5-5, each sample
  scaled as ``v * 255 // 31``; the top bit is alpha), 24 and 32 bits
  (BGR, BGRA); grey at 8 bits, 16 (grey and alpha) and 1; colour maps of
  16- and 24-bit entries from their first index on, entries before it and
  past its end black (Pillow fails 32-bit entries and maps past index
  255, here too).
- The origin flags: rows bottom-up unless bit 5 is set, and mirrored left
  to right where bit 4 is set. The ID field is skipped.
- RLE as Pillow's ``TgaRleDecode.c``: a run packet may not cross the end
  of a row (Pillow fails the image), a raw packet may, and the data ends
  when the last row is full.
- A type and depth the header allows but Pillow has no unpacker for (type
  2 at 8 bits, say) fails, as in Pillow.

TGA has no magic. ``image_pipeline.decode_image`` tries it as Pillow's
``Image.open`` does: after every format before it in ``Image.ID`` has
declined the bytes. A header Pillow declines raises ``Declined``. No
torch: the host-only actor runs it.
"""

from __future__ import annotations

import struct

import numpy as np

from .image_pipeline import Declined

# (image type & 7, depth) → Pillow's raw mode
_RAWMODES = {(1, 8): "P", (3, 1): "1", (3, 8): "L", (3, 16): "LA", (2, 16): "BGRA;15Z", (2, 24): "BGR",
             (2, 32): "BGRA"}


def _rgb555(px: np.ndarray) -> np.ndarray:
    """RGB of little-endian 16-bit pixels [..., 2] as X-R5-G5-B5."""
    v = px[..., 0].astype(np.int32) | (px[..., 1].astype(np.int32) << 8)
    return np.stack([(v >> 10) & 31, (v >> 5) & 31, v & 31], axis=-1) * 255 // 31


def _rle(data: bytes, pos: int, row_bytes: int, unit: int, rows: int) -> bytes:
    """The row bytes of ``rows`` rows of TGA RLE from ``pos``: packets of
    ``unit``-byte pixels."""
    out = bytearray()
    need = row_bytes * rows
    n_data = len(data)
    while len(out) < need:
        if pos >= n_data:
            raise ValueError(f"truncated TGA: the RLE data gives {len(out)} of its {need} bytes")
        head = data[pos]
        n = unit * ((head & 0x7F) + 1)
        if head & 0x80:
            if pos + 1 + unit > n_data:
                raise ValueError("truncated TGA: the file ends inside a run packet")
            if len(out) % row_bytes + n > row_bytes:
                raise ValueError("corrupt TGA: a run packet crosses the end of a row, which PIL does not decode")
            out += data[pos + 1 : pos + 1 + unit] * (n // unit)
            pos += 1 + unit
        else:
            if pos + 1 + n > n_data:
                raise ValueError("truncated TGA: the file ends inside a raw packet")
            out += data[pos + 1 : pos + 1 + n]
            pos += 1 + n
    return bytes(out[:need])


def tga_header(data: bytes) -> tuple | None:
    """The fields Pillow reads from a TGA header, or None where Pillow's
    plugin declines it (too short, colour-map type other than 0 and 1, a
    zero size, a depth other than 1, 8, 16, 24 and 32, an unknown image
    type or origin)."""
    if len(data) < 18:
        return None
    id_len, cmap_type, image_type = data[0], data[1], data[2]
    cmap_start, cmap_len, cmap_depth = struct.unpack("<HHB", data[3:8])
    w, h, depth, flags = struct.unpack("<HHBB", data[12:18])
    if cmap_type not in (0, 1) or w <= 0 or h <= 0 or depth not in (1, 8, 16, 24, 32):
        return None
    if image_type not in (1, 2, 3, 9, 10, 11) or flags & 0x30 not in (0, 0x10, 0x20, 0x30):
        return None
    if cmap_type and cmap_depth not in (16, 24, 32):
        return None
    return id_len, cmap_type, image_type, cmap_start, cmap_len, cmap_depth, w, h, depth, flags


def decode_tga(data: bytes) -> np.ndarray:
    """The RGB uint8 image [H, W, 3] of a TGA file, as PIL's
    ``Image.open(...).convert("RGB")`` gives it; a header Pillow declines
    raises ``Declined``, a truncated or corrupt file ``ValueError`` saying
    what is wrong."""
    data = bytes(data)
    header = tga_header(data)
    if header is None:
        raise Declined("not a TGA file")
    id_len, cmap_type, image_type, cmap_start, cmap_len, cmap_depth, w, h, depth, flags = header
    kind = image_type & 7
    if kind == 3:
        mode = {1: "1", 16: "LA"}.get(depth, "L")
    elif kind == 1:
        mode = "P" if cmap_type else "L"
    else:
        mode = "RGB" if depth == 24 else "RGBA"
    pos = 18 + id_len
    lookup = np.zeros((256, 3), np.uint8)
    rawmode = _RAWMODES.get((kind, depth))
    if cmap_type:
        size = cmap_depth // 8
        raw = data[pos : pos + size * cmap_len]
        pos += size * cmap_len
        if mode == "P" and (cmap_depth == 32 or cmap_start + len(raw) // size > 256):
            raise ValueError(f"a TGA colour map of {cmap_depth}-bit entries {cmap_start}-{cmap_start + cmap_len - 1}, "
                             "which PIL does not load either")
        entries = np.frombuffer(bytes(size * cmap_start) + raw[: len(raw) // size * size], np.uint8).reshape(-1, size)
        rgb = _rgb555(entries) if cmap_depth == 16 else entries[:, 2::-1]
        lookup[: len(rgb)] = rgb
    if rawmode is None:
        raise ValueError(f"a TGA image of type {image_type} at {depth} bits, which PIL does not load either")
    if mode == "L" and rawmode == "P":
        raise ValueError("a colour-mapped TGA without a colour map, which PIL does not decode either")
    row_bytes = (w * depth + 7) // 8
    if image_type & 8:
        body = _rle(data, pos, row_bytes, (depth + 7) // 8, h)
    else:
        if pos + row_bytes * h > len(data):
            raise ValueError(f"truncated TGA: {h} rows of {row_bytes} bytes from byte {pos} run past the file's end")
        body = data[pos : pos + row_bytes * h]
    rows = np.frombuffer(body, np.uint8).reshape(h, row_bytes)
    if rawmode == "1":
        rgb = np.repeat((np.unpackbits(rows, axis=1)[:, :w] * np.uint8(255))[..., None], 3, axis=2)
    elif rawmode in ("L", "LA"):
        rgb = np.repeat(rows.reshape(h, w, -1)[..., :1], 3, axis=2)
    elif rawmode == "P":
        rgb = lookup[rows[:, :w]]
    elif rawmode == "BGRA;15Z":
        rgb = _rgb555(rows.reshape(h, w, 2)).astype(np.uint8)
    else:
        rgb = rows.reshape(h, w, -1)[..., 2::-1]
    if not flags & 0x20:
        rgb = rgb[::-1]
    if flags & 0x10:
        rgb = rgb[:, ::-1]
    return np.ascontiguousarray(rgb, dtype=np.uint8)
