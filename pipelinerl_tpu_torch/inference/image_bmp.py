"""BMP decoding on numpy and the stdlib: what ``PIL.Image.open(...)
.convert("RGB")`` gives, bit for bit, for everything Pillow's
``BmpImagePlugin`` reads, and a refusal where it refuses.

- Headers of 12 (OS/2 1.x: 16-bit sizes, 3-byte palette entries), 40, 52,
  56, 64 (OS/2 2.x), 108 and 124 bytes; a negative height (its top byte
  0xFF) is top-down, else rows run bottom-up.
- ``BI_RGB`` at 1, 4 and 8 bits through a palette, 16 bits as 5-5-5, 24 and
  32 bits as BGR (the fourth byte ignored); ``BI_BITFIELDS`` with Pillow's
  supported masks (5-6-5 and 5-5-5 at 16 bits, byte-aligned ones at 24 and
  32 bits; a mask with alpha keeps the colour bytes); ``BI_RLE8`` and
  ``BI_RLE4`` through a port of Pillow's RLE decoder, quirks included (a
  delta escape reads four bytes, an absolute run's pad follows the file
  position, a run stops at the row's end).
- A palette whose entries are the grey ramp (or black and white for two
  colours) makes Pillow read the samples as "L" (or "1") rather than
  indices, through that mode's unpacker.

``ALPHABITFIELDS``, JPEG and PNG compression, other masks and bit depths
raise, as Pillow does. No torch: the host-only actor runs it.
"""

from __future__ import annotations

import struct

import numpy as np

# Pillow's supported 32-bit BI_BITFIELDS masks (R, G, B, A) → the colour
# bytes' positions (R, G, B) in a little-endian pixel
_BITFIELDS32 = {
    (0xFF0000, 0xFF00, 0xFF, 0x0): (2, 1, 0), (0xFF000000, 0xFF0000, 0xFF00, 0x0): (3, 2, 1),
    (0xFF000000, 0xFF00, 0xFF, 0x0): (3, 1, 0), (0xFF000000, 0xFF0000, 0xFF00, 0xFF): (3, 2, 1),
    (0xFF, 0xFF00, 0xFF0000, 0xFF000000): (0, 1, 2), (0xFF0000, 0xFF00, 0xFF, 0xFF000000): (2, 1, 0),
    (0xFF000000, 0xFF00, 0xFF, 0xFF0000): (3, 1, 0), (0x0, 0x0, 0x0, 0x0): (2, 1, 0),
}


def _refusal(what: str) -> ValueError:
    return ValueError(f"a BMP image with {what}, which PIL does not open either")


def _truncated(what: str) -> ValueError:
    return ValueError(f"truncated BMP: {what}")


def _rle(data: bytes, pos: int, w: int, h: int, rle4: bool) -> bytes:
    """Pillow's ``BmpRleDecoder``: the 8-bit samples of an RLE8 or RLE4
    stream at ``pos``, in file row order."""
    out = bytearray()
    x = 0
    need = w * h
    n = len(data)
    while len(out) < need:
        if pos + 2 > n:
            break
        count, byte = data[pos], data[pos + 1]
        pos += 2
        if count:
            count = min(count, max(0, w - x))
            if rle4:
                pair = bytes([byte >> 4, byte & 15])
                out += (pair * ((count + 1) // 2))[:count]
            else:
                out += bytes([byte]) * count
            x += count
        elif byte == 0:  # end of line
            out += bytes(-len(out) % w)
            x = 0
        elif byte == 1:  # end of bitmap
            break
        elif byte == 2:  # delta: Pillow reads two bytes, then the two after them
            if pos + 2 > n:
                break
            if pos + 4 > n:
                raise _truncated("the file ends inside an RLE delta")
            right, up = data[pos + 2], data[pos + 3]
            pos += 4
            out += bytes(right + up * w)
            x = len(out) % w
        else:  # an absolute run, its bytes padded to the file's next even position
            size = byte // 2 if rle4 else byte
            run = data[pos : pos + size]
            pos += len(run)
            if rle4:
                out += bytes(v for b in run for v in (b >> 4, b & 15))
            else:
                out += run
            if len(run) < size:
                break
            x += byte
            pos += pos % 2
    if len(out) < need:
        raise _truncated(f"the RLE data gives {len(out)} of its {need} samples")
    return bytes(out[:need])


def _unpack(rows: np.ndarray, bits: int, w: int) -> np.ndarray:
    """Samples [h, w] of packed rows [h, bytes], MSB first below 8 bits."""
    if bits == 8:
        return rows[:, :w]
    return np.unpackbits(rows, axis=1).reshape(rows.shape[0], -1, bits).dot(1 << np.arange(bits - 1, -1, -1))[:, :w]


def decode_bmp(data: bytes) -> np.ndarray:
    """The RGB uint8 image [H, W, 3] of a BMP file, as PIL's
    ``Image.open(...).convert("RGB")`` gives it; a truncated or corrupt
    file raises ``ValueError`` saying what is wrong."""
    data = bytes(data)
    if len(data) < 18 or data[:2] != b"BM":
        raise ValueError("not a BMP file: no BM header")
    (offset,) = struct.unpack("<I", data[10:14])
    (hsize,) = struct.unpack("<I", data[14:18])
    if hsize not in (12, 40, 52, 56, 64, 108, 124):
        raise _refusal(f"a {hsize}-byte header")
    if 14 + hsize > len(data):
        raise _truncated(f"the {hsize}-byte header runs past the file's {len(data)} bytes")
    head = data[18 : 14 + hsize]
    pos = 14 + hsize
    masks = None
    if hsize == 12:
        w, h, _, bits = struct.unpack("<HHHH", head[:8])
        compression, colors, entry, top_down = 0, 0, 3, False
    else:
        w, h, _, bits, compression, _, _, _, colors = struct.unpack("<IIHHIIIII", head[:32])
        top_down = head[7] == 0xFF
        if top_down:
            h = 2**32 - h
        entry = 4
        if compression == 3:
            if len(head) >= 48:
                masks = struct.unpack("<III", head[36:48]) + (struct.unpack("<I", head[48:52]) if len(head) >= 52
                                                              else (0,))
            else:
                if pos + 12 > len(data):
                    raise _truncated("the file ends inside the bitfield masks")
                masks = struct.unpack("<III", data[pos : pos + 12]) + (0,)
                pos += 12
    colors = colors or (1 << bits)
    if offset == 14 + hsize and bits <= 8:
        offset += 4 * colors
    if bits not in (1, 4, 8, 16, 24, 32):
        raise _refusal(f"{bits}-bit pixels")
    if compression not in (0, 1, 2, 3):
        names = {4: "JPEG compression", 5: "PNG compression", 6: "ALPHABITFIELDS compression"}
        raise _refusal(names.get(compression, f"compression {compression}"))
    if not w or not h:
        raise ValueError(f"corrupt BMP: a {w}x{h} image")
    # how Pillow unpacks the samples: palette indices ("P"), grey ("L",
    # "1") or colour (the bytes of R, G and B, or 5-5-5 / 5-6-5)
    unpack, lookup = None, None
    if compression == 3:
        if bits == 32 and masks in _BITFIELDS32:
            unpack = ("bytes", 4, _BITFIELDS32[masks])
        elif bits == 24 and masks[:3] == (0xFF0000, 0xFF00, 0xFF):
            unpack = ("bytes", 3, (2, 1, 0))
        elif bits == 16 and masks[:3] in ((0xF800, 0x7E0, 0x1F), (0x7C00, 0x3E0, 0x1F)):
            unpack = ("565",) if masks[0] == 0xF800 else ("555",)
        else:
            raise _refusal(f"{bits}-bit bitfields {tuple(hex(m) for m in masks)}")
    elif bits == 16:
        unpack = ("555",)
    elif bits in (24, 32):
        unpack = ("bytes", bits // 8, (2, 1, 0))
    elif compression in (1, 2) and bits not in ((8,) if compression == 1 else (4,)):
        raise _refusal(f"{'RLE8' if compression == 1 else 'RLE4'} compression at {bits} bits")
    if bits <= 8 and compression != 3:
        if not 0 < colors <= 65536:
            raise _refusal(f"a palette of {colors} colours")
        raw = data[pos : pos + entry * colors]
        if len(raw) < entry * colors:
            raise _truncated(f"a palette of {colors} colours runs past the file's end")
        table = np.frombuffer(raw, np.uint8).reshape(colors, entry)[:, 2::-1]  # BGR(X) → RGB
        grey = (0, 255) if colors == 2 else range(colors)
        if all((table[i] == v).all() for i, v in enumerate(grey)):
            unpack = ("1",) if colors == 2 else ("L",)
        else:
            unpack = ("P",)
            lookup = np.zeros((256, 3), np.uint8)  # entries past the palette read black
            lookup[: min(colors, 256)] = table[:256]
    if compression in (1, 2):
        if unpack[0] == "1":
            raise _refusal("RLE compression and a black-and-white palette")
        samples = np.frombuffer(_rle(data, offset, w, h, compression == 2), np.uint8).reshape(h, w)
    else:
        stride = ((w * bits + 31) >> 3) & ~3
        per = {"P": bits, "L": 8, "1": 1}.get(unpack[0], bits)
        need = (w * per + 7) // 8
        if need > stride:
            raise _refusal(f"{bits}-bit samples and a grey palette that PIL unpacks as 8-bit")
        if offset + stride * (h - 1) + need > len(data):
            raise _truncated(f"{h} rows of {stride} bytes from byte {offset} run past the file's {len(data)} bytes")
        rows = np.frombuffer(data[offset : offset + stride * h].ljust(stride * h, b"\0"), np.uint8).reshape(h, stride)
        if unpack[0] in ("P", "L", "1"):
            samples = _unpack(rows, per, w).astype(np.uint8)
            if unpack[0] == "1":
                samples = samples * np.uint8(255)
        elif unpack[0] == "bytes":
            _, size, (r, g, b) = unpack
            px = rows[:, : w * size].reshape(h, w, size)
            samples = px[..., [r, g, b]]
        else:
            px = rows[:, : 2 * w].reshape(h, w, 2).astype(np.int32)
            v = px[..., 0] | (px[..., 1] << 8)
            if unpack[0] == "555":
                r, g, b = (v >> 10) & 31, (v >> 5) & 31, v & 31
                g = g * 255 // 31
            else:
                r, g, b = (v >> 11) & 31, (v >> 5) & 63, v & 31
                g = g * 255 // 63
            samples = np.stack([r * 255 // 31, g, b * 255 // 31], axis=-1).astype(np.uint8)
    if not top_down:
        samples = samples[::-1]
    if samples.ndim == 3:
        return np.ascontiguousarray(samples)
    if lookup is not None:
        return lookup[samples]
    return np.repeat(samples[..., None], 3, axis=2)
