"""WebP decoding on numpy and the stdlib: what ``PIL.Image.open(...)``
gives on libwebp, bit for bit, as straight RGBA; ``convert("RGB")`` then
drops the alpha.

Pillow opens every WebP through libwebp's ``WebPAnimDecoder``: the first
frame is decoded into a canvas of transparent black at its offset, not
blended, as straight (not premultiplied) RGBA. So ``decode_webp_rgba``
reads:

- the RIFF container in its simple lossy (``VP8 ``), simple lossless
  (``VP8L``) and extended (``VP8X``) forms, ``ALPH`` (raw or
  lossless-compressed alpha; filters none, horizontal, vertical and
  gradient) and the first ``ANMF`` frame of an animation;
- VP8L: prefix codes read LSB first through one lookup table per code,
  meta prefix codes, the colour cache, LZ77 copies with the 120-entry
  distance map; then the inverse transforms on whole arrays (colour
  indexing with pixel bundling, subtract green, the colour transform) and
  the 14 predictors, one numpy step per pixel wavefront ``x + 2y`` and
  predictor mode (a pixel needs its left, top-left, top and top-right
  neighbours);
- VP8: the boolean decoder, the intra modes and the coefficient tokens
  (the one bit-serial part); dequantisation, the WHT and the inverse DCT of
  every block of the frame at once; intra prediction macroblock by
  macroblock from the unfiltered reconstruction with libwebp's 127/129
  borders; the simple or normal loop filter (sharpness, segments, mode
  deltas), one numpy step per macroblock wavefront ``x + 2y``; then
  libwebp's fancy upsampling and its 14-bit YUV → RGB.

A truncated or corrupt file raises ``ValueError`` saying what is wrong. No
torch: the host-only actor runs it.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np


def _corrupt(what: str) -> ValueError:
    return ValueError(f"corrupt WebP: {what}")


def _truncated(what: str) -> ValueError:
    return ValueError(f"truncated WebP: {what}")


# -- VP8L (lossless) -----------------------------------------------------------

_CODE_LENGTH_ORDER = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)
# the first 120 distance codes: (dy << 4) | (8 - dx), distance dx + dy * width
_CODE_TO_PLANE = bytes.fromhex(
    "1807171928062729161a262a38053739151b363a252b48044749141c353b464a242c58454b343c035759131d565a232d444c555b333d6802"
    "6769121e666a222e545c434d656b323e78017779535d111f646c424e767a212f757b313f636d525e00747c414f1020626e30737d515f40727e"
    "616f50717f6070")
# each 15-bit value with its bits reversed
_REV15 = np.zeros(1 << 15, np.int64)
for _b in range(15):
    _REV15 |= ((np.arange(1 << 15) >> _b) & 1) << (14 - _b)
_COLOR_CACHE_MULT = 0x1E35A7BD


class _LBits:
    """VP8L's LSB-first bits: ``words[i]`` holds the 64 bits from byte i
    on, so a read of up to 56 bits is one lookup and a shift."""

    def __init__(self, data: bytes, pos: int = 0):
        n = len(data)
        buf = np.zeros(n + 16, np.uint64)
        buf[:n] = np.frombuffer(data, np.uint8)
        words = np.zeros(n + 8, np.uint64)
        for k in range(8):
            words |= buf[k : k + n + 8] << np.uint64(8 * k)
        self.words = words.tolist()
        self.pos = pos
        self.end = 8 * n

    def read(self, n: int) -> int:
        pos = self.pos
        self.pos = pos + n
        return (self.words[pos >> 3] >> (pos & 7)) & ((1 << n) - 1)


def _prefix_table(lengths: np.ndarray) -> tuple[list[int], int]:
    """A canonical prefix code's lookup table over its longest code's bits,
    read LSB first: entry ``(symbol << 4) | length``; → (table, mask). One
    symbol alone is a code of no bits."""
    nz = np.flatnonzero(lengths)
    if nz.size == 0:
        raise _corrupt("a prefix code without symbols")
    if nz.size == 1:
        return [int(nz[0]) << 4], 0
    lens = lengths[nz]
    counts = np.bincount(lens, minlength=16)
    if int((counts[1:16] << (15 - np.arange(1, 16))).sum()) != 1 << 15:
        raise _corrupt("a prefix code whose lengths do not make a complete code")
    maxlen = int(lens.max())
    order = np.lexsort((nz, lens))
    syms, lens = nz[order], lens[order]
    first = np.zeros(17, np.int64)  # canonical first code of each length
    code = 0
    for length in range(1, 16):
        code = (code + counts[length - 1]) << 1
        first[length] = code
    start = np.searchsorted(lens, np.arange(17))  # first index of each length
    codes = first[lens] + np.arange(lens.size) - start[lens]
    rev = _REV15[codes] >> (15 - lens)
    table = np.zeros(1 << maxlen, np.int64)
    entry = (syms << 4) | lens
    for length in np.unique(lens).tolist():
        sel = lens == length
        fill = np.arange(1 << (maxlen - length)) << length
        table[(rev[sel][:, None] + fill[None, :]).ravel()] = np.repeat(entry[sel], fill.size)
    return table.tolist(), (1 << maxlen) - 1


def _read_symbol(br: _LBits, code: tuple[list[int], int]) -> int:
    table, mask = code
    e = table[(br.words[br.pos >> 3] >> (br.pos & 7)) & mask]
    br.pos += e & 15
    return e >> 4


def _read_code(br: _LBits, alphabet: int) -> tuple[list[int], int]:
    """One prefix code of ``alphabet`` symbols: simple (one or two
    symbols) or normal (code lengths through the code-length code)."""
    lengths = np.zeros(max(alphabet, 256), np.int64)
    if br.read(1):
        n = br.read(1) + 1
        lengths[br.read(8 if br.read(1) else 1)] = 1
        if n == 2:
            lengths[br.read(8)] = 1
        return _prefix_table(lengths[:alphabet])
    cl_lengths = np.zeros(19, np.int64)
    for i in range(br.read(4) + 4):
        cl_lengths[_CODE_LENGTH_ORDER[i]] = br.read(3)
    cl_code = _prefix_table(cl_lengths)
    if br.read(1):
        max_symbol = 2 + br.read(2 + 2 * br.read(3))
        if max_symbol > alphabet:
            raise _corrupt(f"a prefix code of {max_symbol} code lengths for {alphabet} symbols")
    else:
        max_symbol = alphabet
    symbol, prev = 0, 8
    while symbol < alphabet and max_symbol > 0:
        max_symbol -= 1
        length = _read_symbol(br, cl_code)
        if length < 16:
            lengths[symbol] = length
            symbol += 1
            if length:
                prev = length
            continue
        repeat = br.read((2, 3, 7)[length - 16]) + (3, 3, 11)[length - 16]
        if symbol + repeat > alphabet:
            raise _corrupt("a run of code lengths past the alphabet's end")
        lengths[symbol : symbol + repeat] = prev if length == 16 else 0
        symbol += repeat
    return _prefix_table(lengths[:alphabet])


def _sub(size: int, bits: int) -> int:
    return (size + (1 << bits) - 1) >> bits


def _decode_pixels(br: _LBits, w: int, h: int, cache_bits: int, groups: list, hbits: int,
                   himage: list | None) -> list[int]:
    """The ARGB pixels of an entropy-coded image: literals, LZ77 copies and
    colour-cache hits, each group's codes picked by the meta image."""
    total = w * h
    out = [0] * total
    words = br.words
    pos = br.pos
    cache = [0] * (1 << cache_bits) if cache_bits else None
    shift = 32 - cache_bits
    hw = _sub(w, hbits)
    mask = (1 << hbits) - 1 if himage is not None else -1
    plane = _CODE_TO_PLANE
    i = col = row = 0
    (gt, gm), (rt, rm), (bt, bm), (at, am), (dt, dm) = groups[0]
    while i < total:
        if (col & mask) == 0 and himage is not None:
            (gt, gm), (rt, rm), (bt, bm), (at, am), (dt, dm) = groups[himage[(row >> hbits) * hw + (col >> hbits)]]
        e = gt[(words[pos >> 3] >> (pos & 7)) & gm]
        pos += e & 15
        code = e >> 4
        if code < 256:
            e = rt[(words[pos >> 3] >> (pos & 7)) & rm]
            pos += e & 15
            red = e >> 4
            e = bt[(words[pos >> 3] >> (pos & 7)) & bm]
            pos += e & 15
            blue = e >> 4
            e = at[(words[pos >> 3] >> (pos & 7)) & am]
            pos += e & 15
            p = ((e >> 4) << 24) | (red << 16) | (code << 8) | blue
            out[i] = p
            if cache is not None:
                cache[((p * _COLOR_CACHE_MULT) & 0xFFFFFFFF) >> shift] = p
            i += 1
            col += 1
            if col == w:
                col = 0
                row += 1
        elif code < 280:
            sym = code - 256
            if sym < 4:
                length = sym + 1
            else:
                eb = (sym - 2) >> 1
                length = ((2 + (sym & 1)) << eb) + ((words[pos >> 3] >> (pos & 7)) & ((1 << eb) - 1)) + 1
                pos += eb
            e = dt[(words[pos >> 3] >> (pos & 7)) & dm]
            pos += e & 15
            sym = e >> 4
            if sym < 4:
                dist = sym + 1
            else:
                eb = (sym - 2) >> 1
                dist = ((2 + (sym & 1)) << eb) + ((words[pos >> 3] >> (pos & 7)) & ((1 << eb) - 1)) + 1
                pos += eb
            if dist > 120:
                dist -= 120
            else:
                c = plane[dist - 1]
                dist = max(1, (c >> 4) * w + 8 - (c & 15))
            if dist > i or i + length > total:
                raise _corrupt(f"an LZ77 copy of {length} pixels from {dist} back at pixel {i} of {total}")
            if dist >= length:
                seg = out[i - dist : i - dist + length]
            else:
                seg = (out[i - dist : i] * (length // dist + 1))[:length]
            out[i : i + length] = seg
            if cache is not None:
                for p in seg:
                    cache[((p * _COLOR_CACHE_MULT) & 0xFFFFFFFF) >> shift] = p
            i += length
            col += length
            while col >= w:
                col -= w
                row += 1
            if himage is not None and (col & mask) and i < total:
                (gt, gm), (rt, rm), (bt, bm), (at, am), (dt, dm) = groups[
                    himage[(row >> hbits) * hw + (col >> hbits)]]
        else:
            if cache is None or code - 280 >= len(cache):
                raise _corrupt(f"colour cache code {code - 280} without a cache that large")
            p = cache[code - 280]
            out[i] = p
            cache[((p * _COLOR_CACHE_MULT) & 0xFFFFFFFF) >> shift] = p
            i += 1
            col += 1
            if col == w:
                col = 0
                row += 1
    br.pos = pos
    if pos > br.end:
        raise _truncated("the lossless bitstream ends inside its pixels")
    return out


def _decode_stream(br: _LBits, w: int, h: int, level0: bool) -> np.ndarray:
    """One VP8L image stream → uint32 ARGB [h * w]: at level 0 its
    transforms, then the colour cache, (at level 0) the meta prefix codes,
    the prefix codes and the pixels, then the inverse transforms."""
    transforms = []
    xsize = w
    if level0:
        while br.read(1):
            kind = br.read(2)
            if any(t[0] == kind for t in transforms):
                raise _corrupt(f"transform {kind} used twice")
            if kind in (0, 1):
                bits = br.read(3) + 2
                sub = _decode_stream(br, _sub(xsize, bits), _sub(h, bits), False)
                transforms.append((kind, xsize, bits, sub.reshape(_sub(h, bits), _sub(xsize, bits))))
            elif kind == 2:
                transforms.append((2, xsize, 0, None))
            else:
                n = br.read(8) + 1
                bits = 0 if n > 16 else 1 if n > 4 else 2 if n > 2 else 3
                pal = _decode_stream(br, n, 1, False).view(np.uint8).reshape(n, 4)
                palette = np.zeros((1 << (8 >> bits), 4), np.uint8)
                palette[:n] = np.cumsum(pal, axis=0, dtype=np.int64) & 255
                transforms.append((3, xsize, bits, palette.view(np.uint32).ravel()))
                xsize = _sub(xsize, bits)
    cache_bits = 0
    if br.read(1):
        cache_bits = br.read(4)
        if not 1 <= cache_bits <= 11:
            raise _corrupt(f"a colour cache of {cache_bits} bits (1-11 exist)")
    hbits, himage, n_groups = 0, None, 1
    if level0 and br.read(1):
        hbits = br.read(3) + 2
        meta = (_decode_stream(br, _sub(xsize, hbits), _sub(h, hbits), False) >> 8) & 0xFFFF
        n_groups = int(meta.max()) + 1
        himage = meta.tolist()
    cache_size = (1 << cache_bits) if cache_bits else 0
    alphabets = (256 + 24 + cache_size, 256, 256, 256, 40)
    groups = [[_read_code(br, a) for a in alphabets] for _ in range(n_groups)]
    if br.pos > br.end:
        raise _truncated("the lossless bitstream ends inside its prefix codes")
    pixels = np.array(_decode_pixels(br, xsize, h, cache_bits, groups, hbits, himage), np.uint32)
    for kind, tw, bits, data in reversed(transforms):
        pixels = _inverse_transform(kind, tw, h, bits, data, pixels)
    return pixels


def _inverse_transform(kind: int, w: int, h: int, bits: int, data, pixels: np.ndarray) -> np.ndarray:
    if kind == 2:  # subtract green: red and blue plus green
        px = pixels.view(np.uint8).reshape(-1, 4).copy()
        px[:, 0] += px[:, 1]
        px[:, 2] += px[:, 1]
        return px.view(np.uint32).ravel()
    if kind == 3:  # colour indexing, bundled pixels unpacked LSB first
        index = ((pixels >> 8) & 0xFF).reshape(h, -1)
        if bits:
            per, depth = 1 << bits, 8 >> bits
            index = (index[:, :, None] >> (np.arange(per, dtype=np.uint32) * depth)) & ((1 << depth) - 1)
            index = index.reshape(h, -1)[:, :w]
        return data[index.ravel()]
    px = pixels.view(np.uint8).reshape(h, w, 4).astype(np.int32)
    tile = np.repeat(np.repeat(data, 1 << bits, axis=0)[:h], 1 << bits, axis=1)[:, :w]
    if kind == 1:  # the colour transform: multipliers as int8, products >> 5
        m = tile.view(np.uint8).reshape(h, w, 4).view(np.int8).astype(np.int32)
        g = px[..., 1].astype(np.int8).astype(np.int32)
        red = (px[..., 2] + ((m[..., 0] * g) >> 5)) & 255
        blue = (px[..., 0] + ((m[..., 1] * g) >> 5) + ((m[..., 2] * red.astype(np.int8).astype(np.int32)) >> 5)) & 255
        px[..., 2], px[..., 0] = red, blue
        return px.astype(np.uint8).view(np.uint32).ravel()
    return _unpredict(px.reshape(-1, 4), w, h, ((tile >> 8) & 15).astype(np.int64)).view(np.uint32).ravel()


def _avg2(a, b):
    return (a + b) >> 1


def _unpredict(res: np.ndarray, w: int, h: int, modes: np.ndarray) -> np.ndarray:
    """The predictor transform's inverse. Row 0 predicts from the left
    (the first pixel from opaque black), column 0 from above; each other
    pixel by its tile's mode, one wavefront ``x + 2y`` at a time, the
    pixels of one mode together. → uint8 [h * w, 4] (B, G, R, A)."""
    out = res.copy()
    out[0, 3] = (out[0, 3] + 255) & 255
    out[:w] = np.cumsum(out[:w], axis=0) & 255
    if h > 1:
        col = out[::w].copy()
        out[::w] = np.cumsum(col, axis=0) & 255
    if w > 1 and h > 1:
        y, x = np.mgrid[1:h, 1:w]
        f = (y * w + x).ravel()
        key = ((x + 2 * y) * 16 + modes[1:, 1:]).ravel()
        order = np.argsort(key, kind="stable")
        f, key = f[order], key[order]
        cuts = np.flatnonzero(np.diff(key)) + 1
        starts = [0] + cuts.tolist()
        ends = cuts.tolist() + [key.size]
        mode_of = (key[starts] & 15).tolist()
        for a, b, mode in zip(starts, ends, mode_of):
            i = f[a:b]
            out[i] = (out[i] + _predict(out, i, w, mode)) & 255
    return out.astype(np.uint8)


def _predict(out: np.ndarray, i: np.ndarray, w: int, mode: int):
    """VP8L predictor ``mode`` of the pixels at flat indices ``i``."""
    if mode == 0 or mode >= 14:
        return np.array([0, 0, 0, 255], np.int32)
    if mode == 1:
        return out[i - 1]
    if mode == 2:
        return out[i - w]
    if mode == 3:
        return out[i - w + 1]
    if mode == 4:
        return out[i - w - 1]
    if mode == 5:
        return _avg2(_avg2(out[i - 1], out[i - w + 1]), out[i - w])
    if mode == 6:
        return _avg2(out[i - 1], out[i - w - 1])
    if mode == 7:
        return _avg2(out[i - 1], out[i - w])
    if mode == 8:
        return _avg2(out[i - w - 1], out[i - w])
    if mode == 9:
        return _avg2(out[i - w], out[i - w + 1])
    if mode == 10:
        return _avg2(_avg2(out[i - 1], out[i - w - 1]), _avg2(out[i - w], out[i - w + 1]))
    left, top, tl = out[i - 1], out[i - w], out[i - w - 1]
    if mode == 11:  # select: the top unless the left is nearer the gradient
        pick_left = np.abs(left - tl).sum(1) > np.abs(top - tl).sum(1)
        return np.where(pick_left[:, None], left, top)
    if mode == 12:
        return np.clip(left + top - tl, 0, 255)
    a = _avg2(left, top)  # 13: C's division truncates toward zero
    d = a - tl
    return np.clip(a + ((d + (d < 0)) >> 1), 0, 255)


def decode_vp8l(data: bytes) -> np.ndarray:
    """The RGBA uint8 [H, W, 4] of a VP8L chunk's payload."""
    if len(data) < 5 or data[0] != 0x2F:
        raise _corrupt("a VP8L chunk without its 0x2f signature")
    br = _LBits(data, 8)
    w, h = br.read(14) + 1, br.read(14) + 1
    br.read(1)  # alpha_is_used: a hint
    if br.read(3):
        raise _corrupt("a VP8L version other than 0")
    try:
        argb = _decode_stream(br, w, h, True)
    except IndexError:
        raise _truncated("the lossless bitstream ends early") from None
    return _argb_to_rgba(argb, h, w)


def _argb_to_rgba(argb: np.ndarray, h: int, w: int) -> np.ndarray:
    return argb.view(np.uint8).reshape(h, w, 4)[..., [2, 1, 0, 3]]


# -- ALPH ----------------------------------------------------------------------


def decode_alpha(data: bytes, w: int, h: int) -> np.ndarray:
    """An ``ALPH`` chunk's alpha plane uint8 [h, w]: raw or VP8L-coded
    (the green of a headerless VP8L stream), then unfiltered."""
    if not data:
        raise _truncated("an empty ALPH chunk")
    method, filt, pre, rsrv = data[0] & 3, (data[0] >> 2) & 3, (data[0] >> 4) & 3, data[0] >> 6
    if method > 1 or pre > 1 or rsrv:
        raise _corrupt(f"an ALPH header 0x{data[0]:02x} (compression {method}, preprocessing {pre})")
    if method == 0:
        if len(data) - 1 < w * h:
            raise _truncated(f"raw alpha of {len(data) - 1} bytes for {w}x{h} pixels")
        alpha = np.frombuffer(data, np.uint8, w * h, 1).reshape(h, w).astype(np.int32)
    else:
        br = _LBits(data[1:])
        try:
            alpha = ((_decode_stream(br, w, h, True) >> 8) & 0xFF).reshape(h, w).astype(np.int32)
        except IndexError:
            raise _truncated("the alpha bitstream ends early") from None
    return _unfilter_alpha(alpha, filt).astype(np.uint8)


def _unfilter_alpha(a: np.ndarray, filt: int) -> np.ndarray:
    """libwebp's alpha unfilters: row 0 from the left; then horizontal
    (each row's first pixel from above), vertical, or gradient (clipped
    left + top - top-left, one anti-diagonal at a time)."""
    if filt == 0:
        return a
    h, w = a.shape
    out = a.copy()
    out[0] = np.cumsum(a[0]) & 255
    if h == 1:
        return out
    if filt == 1:
        col0 = np.cumsum(a[:, 0]) & 255
        out[1:] = (col0[1:, None] + np.concatenate([np.zeros((h - 1, 1), np.int64),
                                                    np.cumsum(a[1:, 1:], axis=1)], axis=1)) & 255
        return out
    if filt == 2:
        return np.cumsum(out, axis=0) & 255
    out[1:, 0] = np.cumsum(a[:, 0])[1:] & 255  # the first column predicts from above
    for d in range(2, h + w - 1):
        y = np.arange(max(1, d - w + 1), min(h - 1, d - 1) + 1)
        x = d - y
        out[y, x] = (a[y, x] + np.clip(out[y, x - 1] + out[y - 1, x] - out[y - 1, x - 1], 0, 255)) & 255
    return out


# -- VP8 (lossy) ---------------------------------------------------------------

# RFC 6386's tables: quantizer steps, default coefficient probabilities and
# their update probabilities [4 types][8 bands][3 contexts][11], and the
# key frame's 4x4 intra mode probabilities [above][left][9], in libwebp's
# mode order (DC, TM, VE, HE, RD, VR, LD, VL, HD, HU)
_DC_TABLE = bytes.fromhex(
    "0405060708090a0a0b0c0d0e0f101111121314141515161617171819191a1b1c1d1e1f20212223242525262728292a2b2c2d2e2e2f303132"
    "333435363738393a3b3c3d3e3f404142434445464748494a4b4c4c4d4e4f505152535455565758595b5d5f6062646566686a6c6e70727476"
    "7a7c7e80828486888a8c8f9194979a9d"
)
_AC_TABLE = (4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30,
    31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    60, 62, 64, 66, 68, 70, 72, 74, 76, 78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108, 110,
    112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152, 155, 158, 161, 164, 167, 170, 173,
    177, 181, 185, 189, 193, 197, 201, 205, 209, 213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269,
    274, 279, 284)
_COEFF_PROBA0 = bytes.fromhex(
    "808080808080808080808080808080808080808080808080808080808080808080fd88feffe4db8080808080bd81f2ffe3d5ffdb8080806a"
    "7ee3fcd6d1ffff8080800162f8ffece2ffff808080b585eefeddeaff9a8080804e86caf7c6b4ffdb80808001b9f9fff3ff8080808080b896"
    "f7ffece080808080804d6ed8ffece680808080800165fbfff1ff8080808080aa8bf1fcecd1ffff8080802574c4f3e4ffffff80808001ccfe"
    "fff5ff8080808080cfa0faffee8080808080806667e7ffd3ab80808080800198fcfff0ff8080808080b187f3ffeae180808080805081d3ff"
    "c2e080808080800101ff8080808080808080f601ff8080808080808080ff80808080808080808080c623eddfc1bba2a0919b3e832dc6ddac"
    "b0dc9dfcdd01442f92d095a7dda2ffdf800195f1ffdde0ffff808080b88deafddedcffc78080805163b5f2b0bef9caffff800181e8fdd6c5"
    "f2c4ffff806379d2fac9c6ffca808080175ba3f2aabbf7d2ffff8001c8f6ffeaff80808080806db2f1ffe7f5ffff8080802c82c9fdcdc0ff"
    "ff8080800184effbdbd1ffa58080805e88e1fbdabeffff8080801664aef5baa1ffc780808001b6f9ffe8eb80808080807c8ff1ffe3ea8080"
    "808080234db5fbc1d3ffcd808080019df7ffece7ffff808080798debffe1e3ffff8080802d63bcfbc3d9ffe08080800101fbffd5ff808080"
    "8080cb01f8ffff8080808080808901b1ffe0ff8080808080fd09f8fbcfd0ffc0808080af0de0f3c1b9f9c6ffff804911abdda1b3eca7ffea"
    "80015ff7fdd4b7ffff808080ef5af4fad3d1ffff8080809b4dc3f8bcc3ffff8080800118effbdadbffcd808080c933dbffc4ba8080808080"
    "452ebeefc9daffe480808001bffbffff808080808080dfa5f9ffd5ff80808080808d7cf8ffff8080808080800110f8ffff808080808080be"
    "24e6ffecff80808080809501ff808080808080808001e2ff8080808080808080f7c0ff8080808080808080f080ff80808080808080800186"
    "fcffff808080808080d53efaffff808080808080375dff808080808080808080808080808080808080808080808080808080808080808080"
    "8080808080808080ca18d5ebbabfdca0f0afff7e26b6e8a9b8e4aeffbb803d2e8adb97b2f0aaffd8800170e6fac7bff79fffff80a66de4fc"
    "d3d7ffae808080274da2e8acb4f5b2ffff800134dcf6c6c7f9dcffff807c4abff3b7c1faddffff80184782db9aaaf3b6ffff8001b6e1f9db"
    "f0ffe08080809596e2fcd8cdffab8080801c6caaf2b7c2fedfffff800151e6fccccbffc08080807b66d1f7bcc4ffe9808080145f99f3a4ad"
    "ffcb80808001def8ffd8d58080808080a8aff6fcebcdffff8080802f74d7ffd3d4ffff8080800179ecfdd4d6ffff8080808d54d5fcc9caff"
    "db8080802a50a0f0a2b9ffcd8080800101ff8080808080808080f401ff8080808080808080ee01ff8080808080808080"
)
_COEFF_UPDATE = bytes.fromhex(
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffb0f6ffffffffffffffffffdff1fcfffffffffffffffff9"
    "fdfdfffffffffffffffffff4fcffffffffffffffffeafefefffffffffffffffffdfffffffffffffffffffffff6feffffffffffffffffeffd"
    "fefffffffffffffffffefffefffffffffffffffffff8fefffffffffffffffffbfffefffffffffffffffffffffffffffffffffffffffffdfe"
    "fffffffffffffffffbfefefffffffffffffffffefffefffffffffffffffffffefdfffefffffffffffffafffefffefffffffffffffeffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffd9ffffffffffffffffffffe1fcf1fdff"
    "fffeffffffffeafaf1fafdfffdfefffffffffeffffffffffffffffffdffefeffffffffffffffffeefdfefefffffffffffffffff8feffffff"
    "fffffffffff9fefffffffffffffffffffffffffffffffffffffffffffdfffffffffffffffffff7feffffffffffffffffffffffffffffffff"
    "fffffffffffdfefffffffffffffffffcfffffffffffffffffffffffffffffffffffffffffffffefefffffffffffffffffdffffffffffffff"
    "fffffffffffffffffffffffffffffffefdfffffffffffffffffafffffffffffffffffffffeffffffffffffffffffffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffbafbfaffffffffffffffffeafbf4fefffffffffffffffbfbf3fdfefffeffffff"
    "fffffdfeffffffffffffffffecfdfefffffffffffffffffbfdfdfefefffffffffffffffefefffffffffffffffffefefeffffffffffffffff"
    "fffffffffffffffffffffffffefffffffffffffffffffefefffffffffffffffffffefffffffffffffffffffffffffffffffffffffffffffe"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "fffffffffffffffff8fffffffffffffffffffffafefcfefffffffffffffff8fef9fdfffffffffffffffffdfdfffffffffffffffff6fdfdff"
    "fffffffffffffffcfefbfefefffffffffffffffefcfffffffffffffffff8fefdfffffffffffffffffdfffefefffffffffffffffffbfeffff"
    "fffffffffffff5fbfefffffffffffffffffdfdfefffffffffffffffffffbfdfffffffffffffffffcfdfefffffffffffffffffffeffffffff"
    "fffffffffffffcfffffffffffffffffff9fffefffffffffffffffffffffefffffffffffffffffffffdfffffffffffffffffaffffffffffff"
    "fffffffffffffffffffffffffffffffffffffffffffffffffffffeffffffffffffffffffffffffffffffffffffffffff"
)
_BMODE_PROBA = bytes.fromhex(
    "e7783059737178987098b3407eaa762e465faf458f505552489b67383a0aabdabd110d98721a11a32cc3150aad791850c31a3e2c40559047"
    "0a26abd590221aaa2e371388a021ce473f14087272d00c09e251280b60b6541d102486b7598962656aa59448bb64829d6f204b504266a763"
    "4a3e28ea80293509b2f18d1a086b4a2b1a9249a631179d412669a033341f7380684f0c1bd9ff5711075744472c72330fba172f290e6eb6b7"
    "1511c2422d1966c5bd171216585893962a2e2dc4cd2b61b775552623b33d2735c8571a152be8ab3822336872661d5d4d271c55ab3aa55a62"
    "40221674ce17222ba6496b36201a3301512b1f44196a1640ab24e1722213156684bc104c7c3e124e5f5539323033c165239fd76f592e6f3c"
    "941facdbe415126f70714d55b3ff267872282a01c4f5d10a196d582b1d8ca6d5252b9a3d3f1e9b432d4401d16450082b9a01331a478e4e4e"
    "10ff8022c5ab29280566d3b70401dd333211a8d1c01719528a1f24ab1ba6262ce543573aa952731a3bb33f3b5ab43ba65d499a282815748f"
    "d12227af2f0f10b722df312db72e1121b706620f20b7392e16188001361125412049731c801780cd2803097333c01206df572509733b4d40"
    "152f68372cda09363582e2405a46cd2829171a39363970b8052926a6d51e221a8598740a2086271335dd1a722049ff1f0941ea020f017649"
    "4b200c33c0ffa02b33581f2343665537ba553815176f3bcd2d25c03726467c49660122627d622a58685575af525f543559806471652d4b4f"
    "7b2f338051ab0139110547663935293126210d7939491a0155290a438a4d6e5a2f727315020a66ffa61706651d100a558065c41a39120a66"
    "66d522142b75140f24a38044011a663d472522351ff3c0453c472649771cde25442d8022012f0bf5ab3e1113469255373e46252b259a64a3"
    "55a0013f095c881c4020c9554b0f090940ffb8771056061c0540ff19f8013808118489ff3774803a0f145287391a7928a4321f899a851923"
    "da33672c83837b1f069e5628408794e02db780161a1183f09a0e01d12d10155b40de0701c53815279b3c8a1766d5530c0d36c0ff442f1c55"
    "1a555580802092ab120b073f90ab0404f6231b0a92aeab0c1a80be502363b4507e362d557e2f57b033291420654b808b769274805538290f"
    "b0ec5525093e471e117776ff11128a65263c8a37462b1a8e9224131eabff611b148a2d3d3edb0151bc4020291475978e1415a370130c3dc3"
    "80300418"
)
_COEFF_PROBA0 = np.frombuffer(_COEFF_PROBA0, np.uint8).reshape(4, 8, 3, 11)
_COEFF_UPDATE = np.frombuffer(_COEFF_UPDATE, np.uint8).reshape(4, 8, 3, 11)
_BMODE_PROBA = np.frombuffer(_BMODE_PROBA, np.uint8).reshape(10, 10, 9).tolist()
# the 4x4 mode tree: a node's two children, a leaf as -mode
_BMODE_TREE = (0, 1, -1, 2, -2, 3, 4, 6, -3, 5, -4, -5, -6, 7, -7, 8, -8, -9)
_BANDS = (0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0)
_ZIGZAG = (0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15)
_CAT_PROBS = ((173, 148, 140), (176, 155, 140, 135), (180, 157, 141, 134, 130),
              (254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129))
# shifts that bring a range of 1-255 back to 128-255
_NORM = bytes([0] + [7 - r.bit_length() + 1 for r in range(1, 256)])
DC_PRED, TM_PRED, V_PRED, H_PRED = 0, 1, 2, 3


class _Bool:
    """RFC 6386's boolean decoder in libwebp's form: ``rng`` is the range
    less one, ``value`` holds ``bits`` + 8 bits, refilled six bytes at a
    time (zeros past the end, which ``past_end`` reports)."""

    def __init__(self, data: bytes):
        self.data, self.pos = data, 0
        self.value, self.bits, self.rng = 0, -8, 254

    def state(self):
        return self.value, self.bits, self.rng, self.pos

    def load(self, value, bits, rng, pos):
        self.value, self.bits, self.rng, self.pos = value, bits, rng, pos

    def past_end(self) -> bool:
        """Whether a read started past the data, as libwebp's ``eof_``
        says: a read that starts with fewer than 8 of the data's bits left.
        One read shifts out at most 7 bits, so having shifted out at least
        all the data's bits means the last read, at the latest, did."""
        return 8 * self.pos - self.bits - 8 > 8 * len(self.data) - 1

    def bit(self, prob: int) -> int:
        if self.bits < 0:
            self.value = (self.value << 48) | int.from_bytes(self.data[self.pos : self.pos + 6].ljust(6, b"\0"), "big")
            self.pos += 6
            self.bits += 48
        split = (self.rng * prob) >> 8
        if (self.value >> self.bits) > split:
            rng = self.rng - split
            self.value -= (split + 1) << self.bits
            bit = 1
        else:
            rng = split + 1
            bit = 0
        s = _NORM[rng]
        self.rng = (rng << s) - 1
        self.bits -= s
        return bit

    def value_bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit(0x80)
        return v

    def signed(self, n: int) -> int:
        v = self.value_bits(n)
        return -v if self.bit(0x80) else v


@dataclass
class _Frame:
    width: int
    height: int
    mb_w: int
    mb_h: int
    segment_quant: list  # per segment: (y1 dc, y1 ac, y2 dc, y2 ac, uv dc, uv ac)
    filter_type: int  # 0 none, 1 simple, 2 normal
    fstrengths: list  # per segment, per i4x4: (limit, ilevel, hev_thresh)
    proba: list  # bands [4][17] → [3][11] lists
    skip_p: int | None
    update_map: bool
    segment_p: list


def _vp8_header(data: bytes) -> tuple[_Frame, _Bool, list[_Bool]]:
    if len(data) < 10:
        raise _truncated(f"a VP8 chunk of {len(data)} bytes")
    bits = data[0] | (data[1] << 8) | (data[2] << 16)
    key, profile, show, part0 = not bits & 1, (bits >> 1) & 7, (bits >> 4) & 1, bits >> 5
    if not key:
        raise _corrupt("a VP8 frame that is not a key frame")
    if profile > 3 or not show:
        raise _corrupt(f"a VP8 key frame of profile {profile}, shown {show}")
    if data[3:6] != b"\x9d\x01\x2a":
        raise _corrupt("a VP8 key frame without its start code")
    width, height = struct.unpack("<HH", data[6:10])
    width, height = width & 0x3FFF, height & 0x3FFF
    if not width or not height:
        raise _corrupt(f"a {width}x{height} VP8 frame")
    if 10 + part0 > len(data):
        raise _truncated(f"the first partition of {part0} bytes runs past the chunk's {len(data)}")
    br = _Bool(data[10 : 10 + part0])
    br.bit(0x80)  # colour space
    br.bit(0x80)  # clamping type
    use_segment = br.bit(0x80)
    update_map, absolute, seg_q, seg_f, segment_p = False, False, [0] * 4, [0] * 4, [255, 255, 255]
    if use_segment:
        update_map = bool(br.bit(0x80))
        if br.bit(0x80):
            absolute = bool(br.bit(0x80))
            seg_q = [br.signed(7) if br.bit(0x80) else 0 for _ in range(4)]
            seg_f = [br.signed(6) if br.bit(0x80) else 0 for _ in range(4)]
        if update_map:
            segment_p = [br.value_bits(8) if br.bit(0x80) else 255 for _ in range(3)]
    simple, level, sharpness = br.bit(0x80), br.value_bits(6), br.value_bits(3)
    ref_delta, mode_delta = [0] * 4, [0] * 4
    use_lf_delta = br.bit(0x80)
    if use_lf_delta and br.bit(0x80):
        for deltas in (ref_delta, mode_delta):
            for i in range(4):
                if br.bit(0x80):
                    deltas[i] = br.signed(6)
    last = (1 << br.value_bits(2)) - 1
    rest = data[10 + part0 :]
    if len(rest) < 3 * last:
        raise _truncated("the partition sizes run past the chunk")
    parts, start = [], 3 * last
    for p in range(last):
        size = min(rest[3 * p] | (rest[3 * p + 1] << 8) | (rest[3 * p + 2] << 16), len(rest) - start)
        parts.append(_Bool(rest[start : start + size]))
        start += size
    if start >= len(rest):
        raise _truncated("the last token partition is empty")
    parts.append(_Bool(rest[start:]))
    base_q = br.value_bits(7)
    dq = [br.signed(4) if br.bit(0x80) else 0 for _ in range(5)]  # y1 dc, y2 dc, y2 ac, uv dc, uv ac
    quant = []
    for s in range(4):
        q = (seg_q[s] + (0 if absolute else base_q)) if use_segment else base_q

        def clip(v, m):
            return 0 if v < 0 else m if v > m else v

        y2_ac = (_AC_TABLE[clip(q + dq[2], 127)] * 101581) >> 16
        quant.append((_DC_TABLE[clip(q + dq[0], 127)], _AC_TABLE[clip(q, 127)], _DC_TABLE[clip(q + dq[1], 127)] * 2,
                      max(y2_ac, 8), _DC_TABLE[clip(q + dq[3], 117)], _AC_TABLE[clip(q + dq[4], 127)]))
    br.bit(0x80)  # refresh entropy probabilities: no later frame
    proba = _COEFF_PROBA0.copy()
    update = _COEFF_UPDATE.tolist()
    flat = proba.reshape(-1)
    for n, p in enumerate(np.asarray(update).ravel().tolist()):
        if br.bit(p):
            flat[n] = br.value_bits(8)
    bands = [[proba[t, _BANDS[n]].tolist() for n in range(17)] for t in range(4)]
    skip_p = br.value_bits(8) if br.bit(0x80) else None
    filter_type = 0 if level == 0 else 1 if simple else 2
    fstrengths = []
    for s in range(4):
        base = (seg_f[s] + (0 if absolute else level)) if use_segment else level
        per = []
        for i4 in (0, 1):
            lv = base
            if use_lf_delta:
                lv += ref_delta[0] + (mode_delta[0] if i4 else 0)
            lv = min(max(lv, 0), 63)
            if lv == 0:
                per.append((0, 0, 0))
                continue
            ilevel = lv
            if sharpness > 0:
                ilevel >>= 2 if sharpness > 4 else 1
                ilevel = min(ilevel, 9 - sharpness)
            ilevel = max(ilevel, 1)
            per.append((2 * lv + ilevel, ilevel, 2 if lv >= 40 else 1 if lv >= 15 else 0))
        fstrengths.append(per)
    frame = _Frame(width, height, (width + 15) >> 4, (height + 15) >> 4, quant, filter_type, fstrengths, bands,
                   skip_p, update_map, segment_p)
    return frame, br, parts


def _parse_modes(fr: _Frame, br: _Bool) -> tuple[list, ...]:
    """Every macroblock's segment, coded skip, 4x4 flag, luma modes (one
    16x16 mode or sixteen 4x4 ones) and chroma mode, from the first
    partition."""
    n = fr.mb_w * fr.mb_h
    segment, skip, is4, ymodes, uvmode = [0] * n, [0] * n, [0] * n, [None] * n, [0] * n
    top = [DC_PRED] * (4 * fr.mb_w)
    bit = br.bit
    tree, probas = _BMODE_TREE, _BMODE_PROBA
    sp = fr.segment_p
    for my in range(fr.mb_h):
        left = [DC_PRED] * 4
        for mx in range(fr.mb_w):
            k = my * fr.mb_w + mx
            if fr.update_map:
                segment[k] = bit(sp[1]) if not bit(sp[0]) else bit(sp[2]) + 2
            if fr.skip_p is not None:
                skip[k] = bit(fr.skip_p)
            if bit(145):
                mode = (TM_PRED if bit(128) else H_PRED) if bit(156) else (V_PRED if bit(163) else DC_PRED)
                ymodes[k] = mode
                top[4 * mx : 4 * mx + 4] = [mode] * 4
                left = [mode] * 4
            else:
                is4[k] = 1
                modes = []
                for y in range(4):
                    m = left[y]
                    for x in range(4):
                        prob = probas[top[4 * mx + x]][m]
                        i = tree[bit(prob[0])]
                        while i > 0:
                            i = tree[2 * i + bit(prob[i])]
                        m = -i
                        top[4 * mx + x] = m
                        modes.append(m)
                    left[y] = m
                ymodes[k] = modes
            uvmode[k] = DC_PRED if not bit(142) else V_PRED if not bit(114) else TM_PRED if bit(183) else H_PRED
    if br.past_end():
        raise _truncated("the first partition ends inside the macroblock modes")
    return segment, skip, is4, ymodes, uvmode


def _parse_tokens(fr: _Frame, parts: list[_Bool], is4: list, skip: list) -> tuple[np.ndarray, np.ndarray]:
    """Every macroblock's coefficient tokens, undequantized: levels
    int32 [n, 25, 16] in raster order within each block (blocks: 16 luma,
    4 U, 4 V, then Y2), with libwebp's non-zero contexts."""
    n = fr.mb_w * fr.mb_h
    levels = np.zeros(n * 25 * 16, np.int32)
    lv = [0] * 400  # one macroblock's levels
    bands = fr.proba
    zigzag = _ZIGZAG
    cats = _CAT_PROBS
    norm = _NORM
    coded = [0] * n  # whether a macroblock's tokens were read
    top_nz = [0] * fr.mb_w  # libwebp's nz_ bits: 4 luma, 2 U, 2 V; and Y2's
    top_dc = [0] * fr.mb_w
    for my in range(fr.mb_h):
        part = parts[my & (len(parts) - 1)]
        value, bits, rng, pos = part.state()
        data = part.data
        left_nz = left_dc = 0

        def bit(prob):
            nonlocal value, bits, rng, pos
            if bits < 0:
                value = (value << 48) | int.from_bytes(data[pos : pos + 6].ljust(6, b"\0"), "big")
                pos += 6
                bits += 48
            split = (rng * prob) >> 8
            if (value >> bits) > split:
                r = rng - split
                value -= (split + 1) << bits
                s = norm[r]
                rng = (r << s) - 1
                bits -= s
                return 1
            r = split + 1
            s = norm[r]
            rng = (r << s) - 1
            bits -= s
            return 0

        def coeffs(prob, ctx, first, base):
            """libwebp's GetCoeffs: levels of one block into lv[base:],
            → the index past the last non-zero one (or ``first``)."""
            p = prob[first][ctx]
            k = first
            while k < 16:
                if not bit(p[0]):
                    return k
                while not bit(p[1]):
                    k += 1
                    if k == 16:
                        return 16
                    p = prob[k][0]
                if not bit(p[2]):
                    v = 1
                    p = prob[k + 1][1]
                else:
                    if not bit(p[3]):
                        v = 2 if not bit(p[4]) else 3 + bit(p[5])
                    elif not bit(p[6]):
                        v = 5 + bit(159) if not bit(p[7]) else 7 + 2 * bit(165) + bit(145)
                    else:
                        b1 = bit(p[8])
                        cat = 2 * b1 + bit(p[9 + b1])
                        v = 0
                        for q in cats[cat]:
                            v += v + bit(q)
                        v += 3 + (8 << cat)
                    p = prob[k + 1][2]
                lv[base + zigzag[k]] = -v if bit(0x80) else v
                k += 1
            return 16

        for mx in range(fr.mb_w):
            k = my * fr.mb_w + mx
            if skip[k]:
                top_nz[mx] = 0
                left_nz = 0
                if not is4[k]:
                    top_dc[mx] = left_dc = 0
                continue
            coded[k] = 1
            for j in range(400):
                lv[j] = 0
            if not is4[k]:
                nz = coeffs(bands[1], top_dc[mx] + left_dc, 0, 384)
                top_dc[mx] = left_dc = int(nz > 0)
                first, ac = 1, bands[0]
            else:
                first, ac = 0, bands[3]
            tnz, lnz = top_nz[mx] & 0x0F, left_nz & 0x0F
            for y in range(4):
                lb = lnz & 1
                for x in range(4):
                    nz = coeffs(ac, lb + (tnz & 1), first, (4 * y + x) * 16)
                    lb = int(nz > first)
                    tnz = (tnz >> 1) | (lb << 7)
                tnz >>= 4
                lnz = (lnz >> 1) | (lb << 7)
            out_t, out_l = tnz, lnz >> 4
            for ch in (0, 2):
                tnz, lnz = top_nz[mx] >> (4 + ch), left_nz >> (4 + ch)
                for y in range(2):
                    lb = lnz & 1
                    for x in range(2):
                        nz = coeffs(bands[2], lb + (tnz & 1), 0, (16 + 2 * ch + 2 * y + x) * 16)
                        lb = int(nz > 0)
                        tnz = (tnz >> 1) | (lb << 3)
                    tnz >>= 2
                    lnz = (lnz >> 1) | (lb << 5)
                out_t |= (tnz << 4) << ch
                out_l |= (lnz & 0xF0) << ch
            top_nz[mx], left_nz = out_t, out_l
            levels[k * 400 : (k + 1) * 400] = lv
        part.load(value, bits, rng, pos)
    for p in parts:
        if p.past_end():
            raise _truncated("a token partition ends inside the coefficients")
    return levels.reshape(n, 25, 16), np.array(coded, bool)


def _mul1(a):
    return ((a * 20091) >> 16) + a


def _mul2(a):
    return (a * 35468) >> 16


def _idct(c: np.ndarray) -> np.ndarray:
    """libwebp's ``TransformOne`` of blocks [..., 16] (raster order) before
    the add: the residual (v >> 3) of each pixel, int32 [..., 4, 4]."""
    c = c.reshape(c.shape[:-1] + (4, 4)).astype(np.int32)
    i0, i1, i2, i3 = c[..., 0, :], c[..., 1, :], c[..., 2, :], c[..., 3, :]  # rows: vertical pass per column
    a, b = i0 + i2, i0 - i2
    cc, d = _mul2(i1) - _mul1(i3), _mul1(i1) + _mul2(i3)
    t = np.stack([a + d, b + cc, b - cc, a - d], axis=-2)  # [..., 4 (output row), 4 (column)]
    dc = t[..., :, 0] + 4
    a, b = dc + t[..., :, 2], dc - t[..., :, 2]
    cc, d = _mul2(t[..., :, 1]) - _mul1(t[..., :, 3]), _mul1(t[..., :, 1]) + _mul2(t[..., :, 3])
    return np.stack([a + d, b + cc, b - cc, a - d], axis=-1) >> 3


def _iwht(c: np.ndarray) -> np.ndarray:
    """libwebp's ``TransformWHT``: the Y2 blocks [n, 16] → the 16 luma DCs
    [n, 16] in block order."""
    c = c.astype(np.int32)
    a0, a1 = c[:, 0:4] + c[:, 12:16], c[:, 4:8] + c[:, 8:12]
    a2, a3 = c[:, 4:8] - c[:, 8:12], c[:, 0:4] - c[:, 12:16]
    t = np.concatenate([a0 + a1, a3 + a2, a0 - a1, a3 - a2], axis=1).reshape(-1, 4, 4)  # rows 0..3
    dc = t[:, :, 0] + 3
    a0, a1 = dc + t[:, :, 3], t[:, :, 1] + t[:, :, 2]
    a2, a3 = t[:, :, 1] - t[:, :, 2], dc - t[:, :, 3]
    return np.stack([a0 + a1, a3 + a2, a0 - a1, a3 - a2], axis=2).reshape(-1, 16) >> 3


def _int16(x: np.ndarray) -> np.ndarray:
    return x.astype(np.int64).astype(np.int16).astype(np.int32)


def _clip8(x):
    return np.minimum(np.maximum(x, 0), 255)


# the 4x4 predictors as gathers from [edge (13), avg2 (12), avg3 (13)], the
# edge being the left column bottom-up, the corner, the top row and the
# four pixels above-right; DC (0) and TM (1) are computed
def _bmode_gathers() -> dict[int, np.ndarray]:
    e = lambda i: i  # noqa: E731 - L=0 K=1 J=2 I=3 X=4 A=5 B=6 C=7 D=8 E..H=9..12
    a2 = lambda i: 13 + i  # noqa: E731 - (e[i] + e[i + 1] + 1) >> 1
    a3 = lambda i: 25 + i  # noqa: E731 - centred on e[i]
    table = {
        2: [[a3(5 + x) for x in range(4)] for _ in range(4)],  # VE
        3: [[a3(3 - y) for _ in range(4)] for y in range(4)],  # HE
        4: [[a3(4 + x - y) for x in range(4)] for y in range(4)],  # RD
        6: [[a3(6 + x + y) for x in range(4)] for y in range(4)],  # LD
        5: [[a2(4), a2(5), a2(6), a2(7)], [a3(4), a3(5), a3(6), a3(7)],  # VR
            [a3(3), a2(4), a2(5), a2(6)], [a3(2), a3(4), a3(5), a3(6)]],
        7: [[a2(5), a2(6), a2(7), a2(8)], [a3(6), a3(7), a3(8), a3(9)],  # VL
            [a2(6), a2(7), a2(8), a3(10)], [a3(7), a3(8), a3(9), a3(11)]],
        8: [[a2(3), a3(4), a3(5), a3(6)], [a2(2), a3(3), a2(3), a3(4)],  # HD
            [a2(1), a3(2), a2(2), a3(3)], [a2(0), a3(1), a2(1), a3(2)]],
        9: [[a2(2), a3(2), a2(1), a3(1)], [a2(1), a3(1), a2(0), a3(0)],  # HU
            [a2(0), a3(0), e(0), e(0)], [e(0), e(0), e(0), e(0)]],
    }
    return {m: np.array(t, np.int64) for m, t in table.items()}


_BMODE_GATHER = _bmode_gathers()


def _predict4(edge: np.ndarray, mode: int) -> np.ndarray:
    """libwebp's 4x4 intra predictor ``mode`` from its 13 edge samples."""
    if mode == 0:
        return np.full((4, 4), (int(edge[0:4].sum()) + int(edge[5:9].sum()) + 4) >> 3, np.int32)
    if mode == 1:
        return _clip8(edge[5:9][None, :] + edge[3::-1][:, None] - edge[4])
    avg2 = (edge[:-1] + edge[1:] + 1) >> 1
    ext = np.concatenate([edge[1:2], edge, edge[12:13]])
    avg3 = (ext[:-2] + 2 * ext[1:-1] + ext[2:] + 2) >> 2
    avg3[0] = (edge[1] + 3 * edge[0] + 2) >> 2
    return np.concatenate([edge, avg2, avg3])[_BMODE_GATHER[mode]]


def _predict_big(plane: np.ndarray, oy: int, ox: int, size: int, mode: int, mx: int, my: int) -> np.ndarray:
    """libwebp's 16x16 luma or 8x8 chroma predictor at padded (oy, ox),
    DC with the edge variants of ``CheckMode``."""
    top, left, corner = plane[oy - 1, ox : ox + size], plane[oy : oy + size, ox - 1], plane[oy - 1, ox - 1]
    if mode == DC_PRED:
        shift = 5 if size == 16 else 4
        if mx and my:
            dc = (int(top.sum()) + int(left.sum()) + (1 << (shift - 1))) >> shift
        elif mx or my:
            dc = (int((left if mx else top).sum()) + (1 << (shift - 2))) >> (shift - 1)
        else:
            dc = 128
        return np.full((size, size), dc, np.int32)
    if mode == V_PRED:
        return np.broadcast_to(top, (size, size))
    if mode == H_PRED:
        return np.broadcast_to(left[:, None], (size, size))
    return _clip8(top[None, :] + left[:, None] - corner)


def _reconstruct(fr: _Frame, levels: np.ndarray, coded: np.ndarray, segment: list, is4: list, ymodes: list,
                 uvmode: list) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Dequantize, inverse-transform and predict every macroblock in
    raster order from the unfiltered planes. → (Y [16 mb_h, 16 mb_w], U, V
    [8 mb_h, 8 mb_w] int32, whether each macroblock's inner edges are
    filtered)."""
    n = levels.shape[0]
    q = np.array(fr.segment_quant, np.int64)[np.array(segment)]  # [n, 6]
    i4 = np.array(is4, bool)
    lv = levels.astype(np.int64)
    coef = np.empty((n, 25, 16), np.int64)
    coef[:, :16, 0] = lv[:, :16, 0] * np.where(i4, q[:, 0], 0)[:, None]
    coef[:, :16, 1:] = lv[:, :16, 1:] * q[:, 1, None, None]
    coef[:, 16:24, 0] = lv[:, 16:24, 0] * q[:, 4, None]
    coef[:, 16:24, 1:] = lv[:, 16:24, 1:] * q[:, 5, None, None]
    coef[:, 24, 0] = lv[:, 24, 0] * q[:, 2]
    coef[:, 24, 1:] = lv[:, 24, 1:] * q[:, 3, None]
    coef = _int16(coef)
    i16 = ~i4
    coef[i16, :16, 0] = _int16(_iwht(coef[i16, 24]))
    inner = i4 | (coded & (coef[:, :24] != 0).any(axis=(1, 2)))
    res = _idct(coef[:, :24])  # [n, 24, 4, 4]
    mw, mh = fr.mb_w, fr.mb_h
    Y = np.zeros((16 * mh + 1, 16 * mw + 1), np.int32)
    Y[0], Y[1:, 0] = 127, 129
    U = np.zeros((8 * mh + 1, 8 * mw + 1), np.int32)
    U[0], U[1:, 0] = 127, 129
    V = U.copy()
    for k in range(n):
        mx, my = k % mw, k // mw
        oy, ox = 16 * my + 1, 16 * mx + 1
        r = res[k]
        if not i4[k]:
            pred = _predict_big(Y, oy, ox, 16, ymodes[k], mx, my)
            Y[oy : oy + 16, ox : ox + 16] = _clip8(pred + r[:16].reshape(4, 4, 4, 4).transpose(0, 2, 1, 3).reshape(16, 16))
        else:
            if my == 0:
                ar = np.full(4, 127, np.int32)
            elif mx == mw - 1:
                ar = np.full(4, Y[oy - 1, ox + 15], np.int32)
            else:
                ar = Y[oy - 1, ox + 16 : ox + 20].copy()
            for b, mode in enumerate(ymodes[k]):
                by, bx = oy + 4 * (b >> 2), ox + 4 * (b & 3)
                edge = np.concatenate([Y[by : by + 4, bx - 1][::-1], Y[by - 1, bx - 1 : bx + 4],
                                       ar if b & 3 == 3 else Y[by - 1, bx + 4 : bx + 8]])
                Y[by : by + 4, bx : bx + 4] = _clip8(_predict4(edge, mode) + r[b])
        oy, ox = 8 * my + 1, 8 * mx + 1
        for plane, first in ((U, 16), (V, 20)):
            pred = _predict_big(plane, oy, ox, 8, uvmode[k], mx, my)
            plane[oy : oy + 8, ox : ox + 8] = _clip8(pred + r[first : first + 4].reshape(2, 2, 4, 4).transpose(
                0, 2, 1, 3).reshape(8, 8))
    return Y[1:, 1:], U[1:, 1:], V[1:, 1:], inner


def _sclip(x, lo, hi):
    return np.minimum(np.maximum(x, lo), hi)


def _filter_lines(lines: np.ndarray, thresh2: np.ndarray, ilevel: np.ndarray, hev_t: np.ndarray, kind: str):
    """libwebp's edge filters on lines int16 [8, N] (rows p3 p2 p1 p0 | q0
    q1 q2 q3): ``simple``, ``edge`` (macroblock edges: 6 taps, 2 on high
    edge variance) or ``inner`` (4 taps, 2 on high edge variance); → the
    six middle rows filtered."""
    p2, p1, p0, q0, q1, q2 = lines[1:7]
    d = q0 - p0
    pq = p1 - q1
    mask = 4 * np.abs(d) + np.abs(pq) <= thresh2
    a = 3 * d + _sclip(pq, -128, 127)
    f2_p0 = _sclip(p0 + _sclip((a + 3) >> 3, -16, 15), 0, 255)
    f2_q0 = _sclip(q0 - _sclip((a + 4) >> 3, -16, 15), 0, 255)
    out = lines[1:7].copy()
    if kind == "simple":
        out[2] = np.where(mask, f2_p0, p0)
        out[3] = np.where(mask, f2_q0, q0)
        return out
    steps = np.abs(np.diff(lines, axis=0))
    mask &= np.maximum(steps[:3].max(0), steps[4:].max(0)) <= ilevel
    hev = np.maximum(steps[2], steps[4]) > hev_t
    two, wide = mask & hev, mask & ~hev
    if kind == "edge":
        a = _sclip(a, -128, 127)
        a1, a2, a3 = (27 * a + 63) >> 7, (18 * a + 63) >> 7, (9 * a + 63) >> 7
        out = np.where(wide, _sclip(out + np.stack([a3, a2, a1, -a1, -a2, -a3]), 0, 255), out)
    else:
        a1, a2 = _sclip((3 * d + 4) >> 3, -16, 15), _sclip((3 * d + 3) >> 3, -16, 15)
        a3 = (a1 + 1) >> 1
        out[1:5] = np.where(wide, _sclip(out[1:5] + np.stack([a3, a2, -a1, -a3]), 0, 255), out[1:5])
    out[2] = np.where(two, f2_p0, out[2])
    out[3] = np.where(two, f2_q0, out[3])
    return out


_ACROSS = np.arange(-4, 4)[:, None]


def _filter_edges(flat: np.ndarray, width: int, base: np.ndarray, vertical: bool, params: tuple, kind: str) -> None:
    """Filter lines of pixels in place: each line crosses an edge at flat
    index ``base`` (its first pixel past the edge), along a row for a
    vertical edge, down a column for a horizontal one."""
    if not base.size:
        return
    index = base[None, :] + _ACROSS * (1 if vertical else width)
    flat[index[1:7]] = _filter_lines(flat[index], *params, kind)


def _edge_lines(r0: np.ndarray, c0: np.ndarray, size: int, width: int, vertical: bool) -> np.ndarray:
    """The flat index past the edge of each line of edges starting at (r0,
    c0) and running ``size`` pixels down (vertical) or across."""
    along = np.arange(size) * (width if vertical else 1)
    return ((r0 * width + c0)[:, None] + along[None, :]).ravel()


def _loop_filter(fr: _Frame, Y: np.ndarray, U: np.ndarray, V: np.ndarray, segment: list, is4: list,
                 inner: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The loop filter in libwebp's order (per macroblock: left edge, inner
    vertical edges, top edge, inner horizontal edges), one wavefront
    ``x + 2y`` of macroblocks at a time: a macroblock's edges touch only
    those of its left, upper and upper-right neighbours. The planes are
    stacked (U and V side by side under Y), so that a step filters the
    same edge of luma and chroma in one gather."""
    if fr.filter_type == 0:
        return Y, U, V
    n = len(segment)
    st = np.array([fr.fstrengths[s][i] for s, i in zip(segment, is4)], np.int16).reshape(n, 3)
    limit, ilevel, hev_t = st[:, 0], st[:, 1], st[:, 2]
    k = np.flatnonzero(limit > 0)
    mx, my = k % fr.mb_w, k // fr.mb_w
    wave = mx + 2 * my
    order = np.argsort(wave, kind="stable")
    k, mx, my, wave = k[order], mx[order], my[order], wave[order]
    cuts = np.flatnonzero(np.diff(wave)) + 1
    hy, wuv = Y.shape[0], U.shape[1]
    P = np.concatenate([Y, np.concatenate([U, V], axis=1)], axis=0).astype(np.int16)
    width = P.shape[1]
    flat = P.reshape(-1)
    chroma = fr.filter_type == 2
    kind_edge, kind_inner = ("edge", "inner") if chroma else ("simple", "simple")
    for sel in np.split(np.arange(k.size), cuts):
        kk, bx, by = k[sel], mx[sel], my[sel]
        lim, il, hv, inn = limit[kk], ilevel[kk], hev_t[kk], inner[kk]

        def lines(m, off, vertical, uv, extra=0):
            """The edge lines at ``off`` of the macroblocks in mask ``m``
            (luma, and with ``uv`` chroma), with each line's thresholds."""
            x, y = bx[m], by[m]
            r0, c0 = (16 * y, 16 * x + off) if vertical else (16 * y + off, 16 * x)
            base = [_edge_lines(r0, c0, 16, width, vertical)]
            prm = [np.repeat(p, 16) for p in (2 * (lim[m] + extra) + 1, il[m], hv[m])]
            if uv:
                ur, uc = (hy + 8 * y, 8 * x + off // 2) if vertical else (hy + 8 * y + off // 2, 8 * x)
                base += [_edge_lines(ur, uc, 8, width, vertical), _edge_lines(ur, uc + wuv, 8, width, vertical)]
                prm = [np.concatenate([q, np.repeat(p, 8), np.repeat(p, 8)])
                       for q, p in zip(prm, (2 * (lim[m] + extra) + 1, il[m], hv[m]))]
            return np.concatenate(base), tuple(prm)

        for vertical in (True, False):
            edge = (bx > 0) if vertical else (by > 0)
            base, prm = lines(edge, 0, vertical, chroma, extra=4)
            _filter_edges(flat, width, base, vertical, prm, kind_edge)
            for off in (4, 8, 12):
                base, prm = lines(inn, off, vertical, chroma and off == 8)
                _filter_edges(flat, width, base, vertical, prm, kind_inner)
    P = P.astype(np.int32)
    return P[:hy], P[hy:, :wuv], P[hy:, wuv:]


def _fancy_upsample(c: np.ndarray, h: int, w: int) -> np.ndarray:
    """libwebp's fancy upsampler of a chroma plane to [h, w]: each output
    row takes its nearer chroma row with weight 3 and the farther with 1
    (rows past the edge repeat), each column pair the 9-3-3-1 blend of its
    two chroma columns; the first column (and the last, at even widths)
    blends vertically only."""
    ch, cw = c.shape
    r = np.arange(h)
    near = r // 2
    far = np.clip(np.where(r % 2 == 1, near + 1, near - 1), 0, ch - 1)
    N, F = c[near].astype(np.int32), c[far].astype(np.int32)
    out = np.empty((h, w), np.int32)
    out[:, 0] = (3 * N[:, 0] + F[:, 0] + 2) >> 2
    pairs = (w - 1) >> 1
    if pairs:
        tl, t, l, cc = N[:, : pairs], N[:, 1 : pairs + 1], F[:, : pairs], F[:, 1 : pairs + 1]
        avg = tl + t + l + cc + 8
        out[:, 1 : 2 * pairs : 2] = (((avg + 2 * (t + l)) >> 3) + tl) >> 1
        out[:, 2 : 2 * pairs + 1 : 2] = (((avg + 2 * (tl + cc)) >> 3) + t) >> 1
    if w % 2 == 0:
        out[:, w - 1] = (3 * N[:, pairs] + F[:, pairs] + 2) >> 2
    return out


def _yuv_to_rgb(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """libwebp's ``VP8YUVToR/G/B``: 14-bit fixed point, clipped."""
    def clip(x):
        return np.where((x & ~((256 << 6) - 1)) == 0, x >> 6, np.where(x < 0, 0, 255))

    yy = (y * 19077) >> 8
    r = clip(yy + ((v * 26149) >> 8) - 14234)
    g = clip(yy - ((u * 6419) >> 8) - ((v * 13320) >> 8) + 8708)
    b = clip(yy + ((u * 33050) >> 8) - 17685)
    return np.stack([r, g, b], axis=-1).astype(np.uint8)


def decode_vp8(data: bytes, alpha: bytes | None = None) -> np.ndarray:
    """The RGBA uint8 [H, W, 4] of a VP8 key frame (a ``VP8 `` chunk's
    payload), its alpha from an ``ALPH`` chunk's payload or opaque."""
    fr, br, parts = _vp8_header(bytes(data))
    segment, skip, is4, ymodes, uvmode = _parse_modes(fr, br)
    levels, coded = _parse_tokens(fr, parts, is4, skip)
    Y, U, V, inner = _reconstruct(fr, levels, coded, segment, is4, ymodes, uvmode)
    Y, U, V = _loop_filter(fr, Y, U, V, segment, is4, inner)
    h, w = fr.height, fr.width
    ch, cw = (h + 1) // 2, (w + 1) // 2
    rgb = _yuv_to_rgb(Y[:h, :w], _fancy_upsample(U[:ch, :cw], h, w), _fancy_upsample(V[:ch, :cw], h, w))
    a = decode_alpha(alpha, w, h) if alpha is not None else np.full((h, w), 255, np.uint8)
    return np.concatenate([rgb, a[..., None]], axis=-1)


# -- the container -------------------------------------------------------------


def _chunks(data: bytes, pos: int, end: int, where: str):
    """(fourcc, payload, offset) of each chunk in data[pos:end]."""
    while pos + 8 <= end:
        fourcc = data[pos : pos + 4]
        (size,) = struct.unpack("<I", data[pos + 4 : pos + 8])
        if pos + 8 + size > end:
            raise _truncated(f"chunk {fourcc!r} of {size} bytes at byte {pos} runs past the {where}'s end at {end}")
        yield fourcc, data[pos + 8 : pos + 8 + size], pos
        pos += 8 + size + (size & 1)
    if pos < end and end - pos < 8:
        raise _truncated(f"{end - pos} bytes after the last chunk of the {where}")


def _frame_image(chunks, where: str) -> np.ndarray:
    """The RGBA of a frame's chunks: ALPH then VP8, or VP8L."""
    alpha = None
    for fourcc, payload, _ in chunks:
        if fourcc == b"ALPH":
            alpha = alpha if alpha is not None else payload
        elif fourcc == b"VP8 ":
            return decode_vp8(payload, alpha)
        elif fourcc == b"VP8L":
            return decode_vp8l(payload)
    raise _corrupt(f"{where} without a VP8 or VP8L chunk")


def decode_webp_rgba(data: bytes) -> np.ndarray:
    """The straight RGBA uint8 [H, W, 4] that PIL opens a WebP file as
    (libwebp's ``WebPAnimDecoder``, first frame): an animation's first
    frame sits at its offset on a transparent black canvas."""
    data = bytes(data)
    if len(data) < 12 or data[:4] != b"RIFF" or data[8:12] != b"WEBP":
        raise _corrupt("no RIFF/WEBP header")
    (riff,) = struct.unpack("<I", data[4:8])
    end = 8 + riff
    if end > len(data):
        raise _truncated(f"the RIFF header promises {end} bytes, the file holds {len(data)}")
    chunks = list(_chunks(data, 12, end, "file"))
    if not chunks:
        raise _truncated("no chunk after the RIFF header")
    first = chunks[0][0]
    if first in (b"VP8 ", b"VP8L"):
        return _frame_image(chunks[:1], "the file")
    if first != b"VP8X":
        raise _corrupt(f"a first chunk {first!r} (VP8, VP8L or VP8X exist)")
    head = chunks[0][1]
    if len(head) < 10:
        raise _corrupt(f"a VP8X chunk of {len(head)} bytes")
    flags = head[0]
    cw = int.from_bytes(head[4:7], "little") + 1
    chh = int.from_bytes(head[7:10], "little") + 1
    if not flags & 0x02:
        image = _frame_image(chunks[1:], "the file")
        if image.shape[:2] != (chh, cw):
            raise _corrupt(f"a {image.shape[1]}x{image.shape[0]} image on a {cw}x{chh} canvas")
        return image
    frames = [c for c in chunks if c[0] == b"ANMF"]
    if not frames:
        raise _corrupt("an animation without frames")
    body = frames[0][1]
    if len(body) < 16:
        raise _corrupt(f"an ANMF chunk of {len(body)} bytes")
    x0, y0 = 2 * int.from_bytes(body[0:3], "little"), 2 * int.from_bytes(body[3:6], "little")
    fw, fh = int.from_bytes(body[6:9], "little") + 1, int.from_bytes(body[9:12], "little") + 1
    if x0 + fw > cw or y0 + fh > chh:
        raise _corrupt(f"a {fw}x{fh} frame at ({x0}, {y0}) past the {cw}x{chh} canvas")
    image = _frame_image(list(_chunks(body, 16, len(body), "frame")), "the first frame")
    if image.shape[:2] != (fh, fw):
        raise _corrupt(f"a {image.shape[1]}x{image.shape[0]} image in a {fw}x{fh} frame")
    canvas = np.zeros((chh, cw, 4), np.uint8)
    canvas[y0 : y0 + fh, x0 : x0 + fw] = image
    return canvas


def decode_webp(data: bytes) -> np.ndarray:
    """The RGB uint8 image [H, W, 3] of a WebP file, as PIL's
    ``Image.open(...).convert("RGB")`` gives it: the alpha dropped, not
    composited."""
    return np.ascontiguousarray(decode_webp_rgba(data)[..., :3])
