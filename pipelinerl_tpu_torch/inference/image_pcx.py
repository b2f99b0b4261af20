"""PCX decoding on numpy and the stdlib: what ``PIL.Image.open(...)
.convert("RGB")`` gives, bit for bit, for what Pillow's ``PcxImagePlugin``
reads.

- 1 bit in 1 plane (black and white); 1 bit in 2 or 4 planes, indices
  into the header's 16-colour palette; version 5 at 8 bits in 1 plane,
  grey unless a 769-byte palette (marker 12) at the file's end is not the
  grey ramp; version 5 at 8 bits in 3 planes, a row's R, G and B planes in
  turn. Other layouts raise, as in Pillow.
- A row holds ``planes * stride`` bytes, where ``stride`` is the width's
  bytes, made even when the header's own stride differs from it (Pillow
  trusts no header stride); Pillow's ``PcxDecode.c`` moves the planes
  together where that stride is wider than its unpackers read them, and
  where it does not (narrow widths), the planes are read as they lie, as
  here.
- RLE as Pillow decodes it: a byte of the two top bits set repeats the
  next byte ``byte & 63`` times, any other is itself; a run may not cross
  the end of a row (Pillow fails the image).

A header whose box is empty is not a PCX to Pillow, which goes on to its
other plugins; ``Declined`` says so. No torch: the host-only actor runs it.
"""

from __future__ import annotations

import struct

import numpy as np

from .image_pipeline import Declined


def _rle_rows(data: bytes, pos: int, row_bytes: int, rows: int) -> np.ndarray:
    """[rows, row_bytes] of PCX RLE from ``pos``."""
    out = bytearray()
    need = row_bytes * rows
    n = len(data)
    while len(out) < need:
        if pos >= n:
            raise ValueError(f"truncated PCX: the RLE data gives {len(out)} of its {need} bytes")
        byte = data[pos]
        if byte & 0xC0 == 0xC0:
            if pos + 1 >= n:
                raise ValueError("truncated PCX: the file ends inside a run")
            count = byte & 0x3F
            if len(out) % row_bytes + count > row_bytes:
                raise ValueError("corrupt PCX: a run crosses the end of a row, which PIL does not decode")
            out += data[pos + 1 : pos + 2] * count
            pos += 2
        else:
            out.append(byte)
            pos += 1
    return np.frombuffer(bytes(out), np.uint8).reshape(rows, row_bytes)


def _planes(rows: np.ndarray, w: int, planes: int, plane_bytes: int) -> np.ndarray:
    """[h, w] indices of 1-bit planes ``plane_bytes`` apart from each row's
    start, plane i giving bit i (Pillow's ``P;2L`` and ``P;4L``)."""
    out = np.zeros((rows.shape[0], w), np.uint8)
    for i in range(planes):
        out |= np.unpackbits(rows[:, i * plane_bytes : (i + 1) * plane_bytes], axis=1)[:, :w] << i
    return out


def decode_pcx(data: bytes) -> np.ndarray:
    """The RGB uint8 image [H, W, 3] of a PCX file, as PIL's
    ``Image.open(...).convert("RGB")`` gives it; a truncated or corrupt
    file raises ``ValueError`` saying what is wrong."""
    data = bytes(data)
    if len(data) < 68 or data[0] != 10 or data[1] not in (0, 2, 3, 5):
        raise Declined("not a PCX file")
    x0, y0, x1, y1 = struct.unpack_from("<HHHH", data, 4)
    if x1 + 1 <= x0 or y1 + 1 <= y0:
        raise Declined("bad PCX image size")
    version, bits, planes = data[1], data[3], data[65]
    (given_stride,) = struct.unpack_from("<H", data, 66)
    w, h = x1 + 1 - x0, y1 + 1 - y0
    palette = None
    if bits == 1 and planes == 1:
        layout = "1"
    elif bits == 1 and planes in (2, 4):
        layout = "P;L"
        palette = np.zeros((256, 3), np.uint8)
        palette[:16] = np.frombuffer(data, np.uint8, 48, 16).reshape(16, 3)
    elif version == 5 and bits == 8 and planes == 1:
        layout = "L"
        tail = data[-769:]
        if len(tail) == 769 and tail[0] == 12:
            table = np.frombuffer(tail, np.uint8, 768, 1).reshape(256, 3)
            if not (table == np.arange(256)[:, None]).all():
                layout, palette = "P", table
    elif version == 5 and bits == 8 and planes == 3:
        layout = "RGB"
    else:
        raise ValueError(f"a PCX image of {bits} bit(s) in {planes} plane(s) (version {version}), which PIL does not "
                         "open either")
    stride = (w * bits + 7) // 8
    if given_stride != stride:
        stride += stride % 2
    row_bytes = planes * stride
    rows = _rle_rows(data, 128, row_bytes, h)
    # PcxDecode.c moves a row's planes together where their stride is
    # wider than the unpacker reads them: ceil(w / 8) bytes apart at 2 and
    # 4 bits a pixel, else w bytes apart, in ``row_bytes // w`` bands
    if layout == "P;L":
        span, bands = (w + 7) // 8, planes
    else:
        span, bands = w, row_bytes // w
    step = row_bytes // bands if bands else 0
    if step > span:
        rows = rows.copy()
        for i in range(1, bands):
            rows[:, i * span : (i + 1) * span] = rows[:, i * step : i * step + span].copy()
    if layout == "1":
        grey = np.unpackbits(rows, axis=1)[:, :w] * np.uint8(255)
        return np.repeat(grey[..., None], 3, axis=2)
    if layout == "P;L":
        return palette[_planes(rows, w, planes, (w + 7) // 8)]
    if layout == "RGB":
        return np.ascontiguousarray(np.stack([rows[:, i * w : (i + 1) * w] for i in range(3)], axis=-1))
    if palette is not None:
        return palette[rows[:, :w]]
    return np.repeat(rows[:, :w, None], 3, axis=2)
