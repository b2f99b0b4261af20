"""XBM and XPM decoding on the stdlib and numpy: what ``PIL.Image.open(...)
.convert("RGB")`` gives, bit for bit, for what Pillow's ``XbmImagePlugin``
and ``XpmImagePlugin`` read.

- XBM: the header as Pillow's expression matches it in the first 512
  bytes (``#define ..._width N``, ``..._height N``, an optional hot spot,
  then anything up to the last ``_bits[]``); after it, each ``x`` starts a
  byte of the two characters after it (a non-hex digit reads 0), eight
  pixels a byte, least significant bit first, rows padded to whole bytes;
  a set bit is white, as Pillow's ``1;R`` unpacker reads it.
- XPM: the values line (``"W H NCOLORS CPP``) is the first line that starts
  with it; each colour line gives its key (``CPP`` characters after the
  quote) and its ``c`` value: ``#`` and hex digits (the integer's low 24
  bits as RGB), or ``None``, which Pillow keeps as transparency only, so a
  pixel of that key fails the image, here too; any other colour name fails
  the file. Pixel lines are what lies between their first and last quote,
  a ``/* pixels */`` line skipped once; up to 256 colours index a palette,
  more are looked up directly.

No torch: the host-only actor runs it.
"""

from __future__ import annotations

import re

import numpy as np

_XBM_HEAD = re.compile(
    rb"\s*#define[ \t]+.*_width[ \t]+(?P<width>[0-9]+)[\r\n]+"
    rb"#define[ \t]+.*_height[ \t]+(?P<height>[0-9]+)[\r\n]+"
    rb"(?P<hotspot>"
    rb"#define[ \t]+[^_]*_x_hot[ \t]+(?P<xhot>[0-9]+)[\r\n]+"
    rb"#define[ \t]+[^_]*_y_hot[ \t]+(?P<yhot>[0-9]+)[\r\n]+"
    rb")?"
    rb"[\000-\377]*_bits\[]"
)
_XPM_HEAD = re.compile(rb'"([0-9]*) ([0-9]*) ([0-9]*) ([0-9]*)')
_HEX = bytes(int(chr(c), 16) if chr(c) in "0123456789abcdefABCDEF" else 0 for c in range(256))


def decode_xbm(data: bytes) -> np.ndarray:
    """The RGB uint8 image [H, W, 3] of an XBM file, as PIL's
    ``Image.open(...).convert("RGB")`` gives it; a truncated or corrupt
    file raises ``ValueError``."""
    data = bytes(data)
    m = _XBM_HEAD.match(data[:512])
    if not m:
        raise ValueError("not an XBM file: no #define ..._width, ..._height and _bits[] in its first 512 bytes")
    w, h = int(m.group("width")), int(m.group("height"))
    stride = (w + 7) // 8
    need = stride * h
    out = bytearray()
    pos = data.find(b"x", m.end())
    while len(out) < need and 0 <= pos and pos + 3 <= len(data):
        out.append(_HEX[data[pos + 1]] << 4 | _HEX[data[pos + 2]])
        pos = data.find(b"x", pos + 3)
    if len(out) < need:
        raise ValueError(f"truncated XBM: {len(out)} of its {need} bytes")
    rows = np.frombuffer(bytes(out), np.uint8).reshape(h, stride)
    bits = np.unpackbits(rows, axis=1, bitorder="little")[:, :w]
    return np.repeat((bits * np.uint8(255))[..., None], 3, axis=2)


def decode_xpm(data: bytes) -> np.ndarray:
    """The RGB uint8 image [H, W, 3] of an XPM file, as PIL's
    ``Image.open(...).convert("RGB")`` gives it; a truncated or corrupt
    file raises ``ValueError`` saying what is wrong."""
    data = bytes(data)
    if not data.startswith(b"/* XPM */"):
        raise ValueError("not an XPM file")
    lines = data[9:].split(b"\n")  # Pillow's readline: LF ends a line
    lines = [line + b"\n" for line in lines[:-1]] + ([lines[-1]] if lines[-1] else [])
    for i, line in enumerate(lines):
        m = _XPM_HEAD.match(line)
        if m:
            break
    else:
        raise ValueError("broken XPM file: no values line")
    w, h, n_colors, cpp = (int(g) for g in m.groups())
    palette: dict[bytes, bytes] = {}
    rest = iter(lines[i + 1 :])
    for _ in range(n_colors):
        line = next(rest, b"").rstrip()
        key, words = line[1 : cpp + 1], line[cpp + 1 : -2].split()
        for j in range(0, len(words), 2):
            if words[j] == b"c":
                value = words[j + 1]
                if value.startswith(b"#"):
                    v = int(value[1:], 16)
                    palette[key] = bytes(((v >> 16) & 255, (v >> 8) & 255, v & 255))
                elif value != b"None":
                    raise ValueError(f"an XPM colour {value.decode(errors='replace')!r}, which PIL does not read "
                                     "either (only #-hex colours and None)")
                break
        else:
            raise ValueError("corrupt XPM: a colour line without a 'c' key")
    keys = list(palette)
    pixels, header_seen = [], False
    need = w * h
    for line in rest:
        if len(pixels) >= need:
            break
        if line.rstrip() == b"/* pixels */" and not header_seen:
            header_seen = True
            continue
        body = b'"'.join(line.split(b'"')[1:-1])
        for j in range(0, len(body), cpp):
            key = body[j : j + cpp]
            if key not in palette:
                raise ValueError(f"corrupt XPM: a pixel of key {key!r}, which has no colour (or is transparent: PIL "
                                 "fails such a file too)")
            pixels.append(key)
    if len(pixels) < need:
        raise ValueError(f"truncated XPM: {len(pixels)} of its {need} pixels")
    if n_colors > 256:
        return np.frombuffer(b"".join(palette[k] for k in pixels[:need]), np.uint8).reshape(h, w, 3).copy()
    lookup = np.zeros((256, 3), np.uint8)
    lookup[: len(keys)] = np.frombuffer(b"".join(palette.values()), np.uint8).reshape(-1, 3)
    index = {k: i for i, k in enumerate(keys)}
    return lookup[np.asarray([index[k] for k in pixels[:need]], np.uint8).reshape(h, w)]
