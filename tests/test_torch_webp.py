"""The port's WebP decoder (``inference/image_webp``) against PIL on
libwebp, bit for bit: the RGB that ``Image.open(...).convert("RGB")``
gives and, where PIL opens the file as RGBA, the RGBA too. Files PIL
writes (lossless and lossy over qualities and methods, with and without
alpha, ``exact``, animations), and files written here for what PIL's
encoder does not choose: ``ALPH`` raw and lossless-compressed under each
of its four filters, an extended still image, an animation whose first
frame sits at an offset on a larger canvas. Truncated and corrupt files
raise saying what is wrong.
"""

import io
import struct

import numpy as np
import pytest
from PIL import Image

from pipelinerl_tpu_torch.inference import image_pipeline as ip
from pipelinerl_tpu_torch.inference import image_webp as wp


def pil_open(data: bytes) -> Image.Image:
    image = Image.open(io.BytesIO(data))
    image.load()
    return image


def assert_decodes_as_pil(data: bytes) -> np.ndarray:
    image = pil_open(data)
    want = np.asarray(image.convert("RGB"))
    got = wp.decode_webp(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ip.decode_image(data), want)
    rgba = wp.decode_webp_rgba(data)
    if image.mode == "RGBA":
        np.testing.assert_array_equal(rgba, np.asarray(image))
    return rgba


def pil_webp(pixels: np.ndarray, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(pixels).save(buf, "WEBP", **kw)
    return buf.getvalue()


def noise(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def smooth(h, w, seed, channels=3):
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([x * 255 // max(w - 1, 1), y * 255 // max(h - 1, 1), (x + y) * 127 // max(h + w - 2, 1),
                     255 - x * 200 // max(w - 1, 1)][:channels], -1)
    return np.clip(base + np.random.default_rng(seed).normal(0, 8, (h, w, channels)), 0, 255).astype(np.uint8)


# -- files PIL writes ----------------------------------------------------------

SIZES = [(1, 1), (7, 9), (17, 33), (48, 64)]


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("kw", [dict(lossless=True), dict(lossless=True, quality=0, method=0),
                                dict(lossless=True, quality=100, method=6), dict(lossless=True, exact=True)],
                         ids=["default", "fast", "best", "exact"])
@pytest.mark.parametrize("channels", [3, 4])
def test_lossless(kw, size, channels):
    """VP8L: the transforms, colour cache, meta prefix codes and LZ77 the
    encoder chooses for noise and for smooth images, with and without
    alpha."""
    for pixels in (noise(size + (channels,), size[0]), smooth(*size, 1, channels)):
        assert_decodes_as_pil(pil_webp(pixels, **kw))


@pytest.mark.parametrize("size", SIZES + [(31, 17)])
@pytest.mark.parametrize("kw", [dict(quality=5), dict(quality=50, method=0), dict(quality=80),
                                dict(quality=100, method=6)], ids=["q5", "q50m0", "q80", "q100m6"])
def test_lossy(kw, size):
    """VP8: segments and quantizers, i16 and i4 modes, skipped blocks, the
    normal loop filter, odd sizes for the fancy upsampler."""
    for pixels in (noise(size + (3,), size[1]), smooth(*size, 2)):
        assert_decodes_as_pil(pil_webp(pixels, **kw))


@pytest.mark.parametrize("kw", [dict(quality=80), dict(quality=60, alpha_quality=30), dict(quality=90, method=6)])
def test_lossy_with_alpha(kw):
    """``ALPH`` as libwebp's encoder writes it (lossless-coded, its filter
    chosen by the encoder, levels preprocessed below alpha quality 100)."""
    for pixels in (noise((23, 29, 4), 3), smooth(40, 56, 4, 4)):
        rgba = assert_decodes_as_pil(pil_webp(pixels, **kw))
        assert rgba.shape[-1] == 4


def test_animation_first_frame():
    frames = [Image.fromarray(smooth(30, 44, s)) for s in range(3)]
    for kw in (dict(quality=70), dict(lossless=True)):
        buf = io.BytesIO()
        frames[0].save(buf, "WEBP", save_all=True, append_images=frames[1:], duration=90, **kw)
        assert pil_open(buf.getvalue()).n_frames == 3
        assert_decodes_as_pil(buf.getvalue())


def test_larger_images():
    """Chart-sized files: 300x400, lossy and lossless."""
    pixels = np.kron(noise((30, 40, 3), 5), np.ones((10, 10, 1), np.uint8))
    assert_decodes_as_pil(pil_webp(pixels, quality=75))
    assert_decodes_as_pil(pil_webp(pixels, lossless=True))


# -- files written here --------------------------------------------------------


def chunk(fourcc: bytes, payload: bytes) -> bytes:
    return fourcc + struct.pack("<I", len(payload)) + payload + (b"\0" if len(payload) % 2 else b"")


def riff(*chunks: bytes) -> bytes:
    body = b"WEBP" + b"".join(chunks)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def image_chunk(data: bytes) -> bytes:
    """The VP8 or VP8L chunk of a simple-format file PIL wrote."""
    assert data[12:16] in (b"VP8 ", b"VP8L")
    (size,) = struct.unpack("<I", data[16:20])
    return data[12 : 20 + size + (size & 1)]


def vp8x(flags: int, w: int, h: int) -> bytes:
    return chunk(b"VP8X", bytes([flags, 0, 0, 0]) + (w - 1).to_bytes(3, "little") + (h - 1).to_bytes(3, "little"))


def filter_alpha(a: np.ndarray, method: int) -> np.ndarray:
    """libwebp's alpha filters (the inverse of the decoder's): row 0 from
    the left; horizontal (each row's first pixel from above), vertical,
    gradient (clipped left + top - top-left)."""
    a = a.astype(np.int64)
    if method == 0:
        return a.astype(np.uint8)
    pred = np.zeros_like(a)
    pred[0, 1:] = a[0, :-1]
    if method == 1:
        pred[1:, 0] = a[:-1, 0]
        pred[1:, 1:] = a[1:, :-1]
    elif method == 2:
        pred[1:] = a[:-1]
    else:
        pred[1:, 0] = a[:-1, 0]
        pred[1:, 1:] = np.clip(a[1:, :-1] + a[:-1, 1:] - a[:-1, :-1], 0, 255)
    return ((a - pred) & 255).astype(np.uint8)


def alph(alpha: np.ndarray, method: int, compressed: bool) -> bytes:
    """An ALPH chunk: the filtered plane raw, or as the green of a
    headerless VP8L stream (PIL's lossless encoder, its 5-byte header
    cut)."""
    filtered = filter_alpha(alpha, method)
    header = bytes([(method << 2) | int(compressed)])
    if not compressed:
        return chunk(b"ALPH", header + filtered.tobytes())
    green = np.zeros(alpha.shape + (4,), np.uint8)
    green[..., 1] = filtered
    green[..., 3] = 255
    stream = image_chunk(pil_webp(green, lossless=True, exact=True))
    return chunk(b"ALPH", header + stream[8 + 5 : 8 + struct.unpack("<I", stream[4:8])[0]])


@pytest.mark.parametrize("compressed", [False, True])
@pytest.mark.parametrize("method", [0, 1, 2, 3], ids=["none", "horizontal", "vertical", "gradient"])
def test_alph_filters(method, compressed):
    """A lossy image with an ALPH chunk under each filter, raw and
    lossless-compressed: PIL's RGBA, alpha included."""
    h, w = 27, 35
    alpha = smooth(h, w, 6, 1)[..., 0] if method else noise((h, w), 7)
    vp8 = image_chunk(pil_webp(smooth(h, w, 8), quality=80))
    data = riff(vp8x(0x10, w, h), alph(alpha, method, compressed), vp8)
    image = pil_open(data)
    assert image.mode == "RGBA"
    np.testing.assert_array_equal(np.asarray(image)[..., 3], alpha)
    np.testing.assert_array_equal(assert_decodes_as_pil(data)[..., 3], alpha)


@pytest.mark.parametrize("kind", ["lossy", "lossless"])
def test_extended_still(kind):
    """A VP8X still image around a simple one, with an unknown chunk
    beside it."""
    pixels = smooth(20, 30, 9)
    inner = image_chunk(pil_webp(pixels, quality=70) if kind == "lossy" else pil_webp(pixels, lossless=True))
    assert_decodes_as_pil(riff(vp8x(0, 30, 20), chunk(b"ABCD", b"x" * 5), inner))


@pytest.mark.parametrize("kind", ["lossy", "lossless", "lossy_alpha"])
def test_animation_first_frame_at_an_offset(kind):
    """An animation's first frame smaller than the canvas: libwebp's
    animation decoder puts it at its offset on transparent black, so the
    rest reads (0, 0, 0)."""
    fh, fw, x0, y0, ch, cw = 14, 18, 6, 4, 30, 40
    pixels = smooth(fh, fw, 10)
    if kind == "lossless":
        frame = image_chunk(pil_webp(pixels, lossless=True))
    else:
        frame = image_chunk(pil_webp(pixels, quality=75))
        if kind == "lossy_alpha":
            frame = alph(smooth(fh, fw, 11, 1)[..., 0], 1, True) + frame
    anmf = (x0 // 2).to_bytes(3, "little") + (y0 // 2).to_bytes(3, "little") + (fw - 1).to_bytes(3, "little") + \
        (fh - 1).to_bytes(3, "little") + (100).to_bytes(3, "little") + bytes([0])
    second = image_chunk(pil_webp(smooth(ch, cw, 12), quality=50))
    anmf2 = bytes(6) + (cw - 1).to_bytes(3, "little") + (ch - 1).to_bytes(3, "little") + (100).to_bytes(3, "little") + \
        bytes([0])
    data = riff(vp8x(0x02 | (0x10 if kind != "lossy" else 0), cw, ch), chunk(b"ANIM", bytes(6)),
                chunk(b"ANMF", anmf + frame), chunk(b"ANMF", anmf2 + second))
    rgba = assert_decodes_as_pil(data)
    assert rgba.shape[:2] == (ch, cw)
    assert not rgba[:y0].any() and not rgba[:, :x0].any()


# -- refusals ------------------------------------------------------------------


def good_file(kind: str) -> bytes:
    pixels = smooth(32, 40, 13, 4)
    return pil_webp(pixels, quality=80) if kind == "lossy" else pil_webp(pixels, lossless=True)


@pytest.mark.parametrize("kind", ["lossy", "lossless"])
@pytest.mark.parametrize("cut", [0.01, 0.3, 0.7, 0.98])
def test_truncated_files_raise(kind, cut):
    data = good_file(kind)
    short = data[: max(13, int(len(data) * cut))]
    with pytest.raises((OSError, SyntaxError, ValueError)):
        pil_open(short)
    with pytest.raises(ValueError, match="truncated WebP"):
        wp.decode_webp(short)


def test_truncated_bitstreams_inside_a_whole_container_raise():
    """A chunk cut short with the RIFF and chunk sizes rewritten to match:
    the bitstream itself ends early."""
    for kind in ("lossy", "lossless"):
        pixels = smooth(32, 40, 15)
        inner = image_chunk(pil_webp(pixels, quality=80) if kind == "lossy" else pil_webp(pixels, lossless=True))
        payload = inner[8 : 8 + struct.unpack("<I", inner[4:8])[0]]
        data = riff(chunk(inner[:4], payload[: len(payload) // 2]))
        with pytest.raises((OSError, SyntaxError, ValueError)):
            pil_open(data)
        with pytest.raises(ValueError, match="truncated WebP"):
            wp.decode_webp(data)


def test_corrupt_files_raise_saying_what_is_wrong():
    lossy = bytearray(good_file("lossy"))
    at = lossy.index(b"\x9d\x01\x2a")
    lossy[at] = 0x9C
    with pytest.raises(ValueError, match="corrupt WebP: a VP8 key frame without its start code"):
        wp.decode_webp(bytes(lossy))
    lossless = bytearray(good_file("lossless"))
    lossless[20] = 0x2E
    with pytest.raises(ValueError, match="corrupt WebP: a VP8L chunk without its 0x2f signature"):
        wp.decode_webp(bytes(lossless))
    bad_alph = riff(vp8x(0x10, 4, 4), chunk(b"ALPH", bytes([0x03]) + bytes(16)),
                    image_chunk(pil_webp(smooth(4, 4, 14), quality=80)))
    with pytest.raises(ValueError, match="corrupt WebP: an ALPH header"):
        wp.decode_webp(bad_alph)
    with pytest.raises(ValueError, match="corrupt WebP: a first chunk"):
        wp.decode_webp(riff(chunk(b"JUNK", b"1234")))


# -- a VP8 encoder for the header fields libwebp's encoder does not vary -------


class BoolEncoder:
    """RFC 6386's boolean encoder (section 7.3)."""

    def __init__(self):
        self.out = bytearray()
        self.range, self.bottom, self.bit_count = 255, 0, 24

    def _carry(self):
        i = len(self.out) - 1
        while self.out[i] == 255:
            self.out[i] = 0
            i -= 1
        self.out[i] += 1

    def put(self, prob: int, bit: int):
        split = 1 + (((self.range - 1) * prob) >> 8)
        if bit:
            self.bottom += split
            self.range -= split
        else:
            self.range = split
        while self.range < 128:
            self.range <<= 1
            if self.bottom & (1 << 31):
                self._carry()
            self.bottom = (self.bottom << 1) & 0xFFFFFFFF
            self.bit_count -= 1
            if not self.bit_count:
                self.out.append(self.bottom >> 24)
                self.bottom &= (1 << 24) - 1
                self.bit_count = 8

    def value(self, v: int, n: int):
        for i in range(n - 1, -1, -1):
            self.put(128, (v >> i) & 1)

    def signed(self, v: int, n: int):
        self.value(abs(v), n)
        self.put(128, int(v < 0))

    def optional(self, v: int, n: int, signed: bool = True):
        """A flag, then the value when it is not 0."""
        self.put(128, int(v != 0))
        if v:
            (self.signed if signed else self.value)(v, n)

    def finish(self) -> bytes:
        c, v = self.bit_count, self.bottom
        if v & (1 << (32 - c)):
            self._carry()
        v = (v << (c & 7)) & 0xFFFFFFFF
        for _ in range(c >> 3):
            v = (v << 8) & 0xFFFFFFFF
        for _ in range(4):
            self.out.append(v >> 24)
            v = (v << 8) & 0xFFFFFFFF
        return bytes(self.out)


def tree_paths(tree) -> dict[int, list]:
    """Each leaf's (node, bit) path in a VP8 tree laid out as the
    decoder walks it (node i's children at 2i and 2i + 1, leaves -value)."""
    paths, todo = {}, [(0, [])]
    while todo:
        node, path = todo.pop()
        for bit in (0, 1):
            child = tree[2 * node + bit]
            if child > 0:
                todo.append((child, path + [(node, bit)]))
            else:
                paths[-child] = path + [(node, bit)]
    return paths


BMODE_PATHS = tree_paths(wp._BMODE_TREE)


def put_tokens(enc: BoolEncoder, probs, ctx: int, first: int, levels) -> int:
    """One block's levels (raster order) as libwebp's ``GetCoeffs`` reads
    them; → the index past the last non-zero level (or ``first``)."""
    z = [levels[wp._ZIGZAG[n]] for n in range(16)]
    last = max((n for n in range(first, 16) if z[n]), default=-1)
    p = probs[first][ctx]
    n = first
    while n < 16:
        if n > last:
            enc.put(p[0], 0)
            return n
        enc.put(p[0], 1)
        while z[n] == 0:
            enc.put(p[1], 0)
            n += 1
            p = probs[n][0]
        enc.put(p[1], 1)
        v = abs(z[n])
        if v == 1:
            enc.put(p[2], 0)
            nxt = 1
        else:
            enc.put(p[2], 1)
            if v <= 4:
                enc.put(p[3], 0)
                enc.put(p[4], int(v > 2))
                if v > 2:
                    enc.put(p[5], v - 3)
            elif v <= 10:
                enc.put(p[3], 1)
                enc.put(p[6], 0)
                enc.put(p[7], int(v > 6))
                if v <= 6:
                    enc.put(159, v - 5)
                else:
                    enc.put(165, (v - 7) >> 1)
                    enc.put(145, (v - 7) & 1)
            else:
                cat = 0 if v < 19 else 1 if v < 35 else 2 if v < 67 else 3
                enc.put(p[3], 1)
                enc.put(p[6], 1)
                enc.put(p[8], cat >> 1)
                enc.put(p[9 + (cat >> 1)], cat & 1)
                extra = v - (3 + (8 << cat))
                tab = wp._CAT_PROBS[cat]
                for i, q in enumerate(tab):
                    enc.put(q, (extra >> (len(tab) - 1 - i)) & 1)
            nxt = 2
        enc.put(128, int(z[n] < 0))
        n += 1
        p = probs[n][nxt]
    return 16


def encode_vp8(w: int, h: int, seed: int, *, simple=0, level=20, sharpness=0, ref_delta=0, mode_delta=0,
               segments=None, parts=1, skip_prob=None, base_q=20, dq=(0, 0, 0, 0, 0), big=8) -> bytes:
    """A VP8 key frame of random content: random intra modes, segment ids
    and sparse levels up to ``big``, with the given loop filter (simple or
    normal, level, sharpness, the reference and i4x4 mode deltas),
    segments ((absolute, quantizers, filter levels) or None), token
    partitions, skip probability, quantizer index and deltas."""
    rng = np.random.default_rng(seed)
    mw, mh = (w + 15) // 16, (h + 15) // 16
    bands = [[wp._COEFF_PROBA0[t, wp._BANDS[n]].tolist() for n in range(17)] for t in range(4)]
    enc = BoolEncoder()
    enc.value(0, 1)  # colour space
    enc.value(0, 1)  # clamping
    enc.put(128, int(segments is not None))
    seg_p = [int(x) for x in rng.integers(30, 220, 3)]
    if segments is not None:
        absolute, quants, filters = segments
        enc.put(128, 1)  # update the map
        enc.put(128, 1)  # update the data
        enc.put(128, int(absolute))
        for q in quants:
            enc.optional(q, 7)
        for f in filters:
            enc.optional(f, 6)
        for p in seg_p:
            enc.put(128, 1)
            enc.value(p, 8)
    enc.put(128, simple)
    enc.value(level, 6)
    enc.value(sharpness, 3)
    enc.put(128, int(bool(ref_delta or mode_delta)))
    if ref_delta or mode_delta:
        enc.put(128, 1)
        for deltas in ((ref_delta, 0, 0, 0), (mode_delta, 0, 0, 0)):
            for d in deltas:
                enc.optional(d, 6)
    enc.value(parts.bit_length() - 1, 2)
    enc.value(base_q, 7)
    for d in dq:
        enc.optional(d, 4)
    enc.put(128, 0)  # no later frame refreshes the probabilities
    for p in wp._COEFF_UPDATE.ravel().tolist():
        enc.put(p, 0)
    enc.put(128, int(skip_prob is not None))
    if skip_prob is not None:
        enc.value(skip_prob, 8)
    top = [0] * (4 * mw)
    macroblocks = []
    for my in range(mh):
        left = [0] * 4
        for mx in range(mw):
            seg = int(rng.integers(0, 4)) if segments is not None else 0
            i4 = bool(rng.random() < 0.5)
            levels = np.zeros((25, 16), np.int64)
            live = rng.random((25, 16)) < np.where(np.arange(16) < 3, 0.5, 0.08)
            levels[live] = rng.integers(1, big + 1, int(live.sum())) * rng.choice([-1, 1], int(live.sum()))
            if i4:
                levels[24] = 0
            else:
                levels[:16, 0] = 0
            if rng.random() < 0.2:
                levels[:] = 0
            skip = skip_prob is not None and not levels.any()
            if segments is not None:
                if seg < 2:
                    enc.put(seg_p[0], 0)
                    enc.put(seg_p[1], seg)
                else:
                    enc.put(seg_p[0], 1)
                    enc.put(seg_p[2], seg - 2)
            if skip_prob is not None:
                enc.put(skip_prob, int(skip))
            enc.put(145, int(not i4))
            if not i4:
                ymode = int(rng.integers(0, 4))  # DC, TM, V, H
                enc.put(156, int(ymode in (1, 3)))
                enc.put(128 if ymode in (1, 3) else 163, int(ymode in (1, 2)))
                top[4 * mx : 4 * mx + 4] = [ymode] * 4
                left = [ymode] * 4
            else:
                for y in range(4):
                    m = left[y]
                    for x in range(4):
                        mode = int(rng.integers(0, 10))
                        prob = wp._BMODE_PROBA[top[4 * mx + x]][m]
                        for node, bit in BMODE_PATHS[mode]:
                            enc.put(prob[node], bit)
                        m = top[4 * mx + x] = mode
                    left[y] = m
            uv = int(rng.integers(0, 4))
            enc.put(142, int(uv != 0))
            if uv:
                enc.put(114, int(uv != 2))
                if uv != 2:
                    enc.put(183, int(uv == 1))
            macroblocks.append((i4, skip, levels))
    first = enc.finish()
    token = [BoolEncoder() for _ in range(parts)]
    top_nz, top_dc = [0] * mw, [0] * mw
    for my in range(mh):
        e = token[my % parts]
        left_nz = left_dc = 0
        for mx in range(mw):
            i4, skip, levels = macroblocks[my * mw + mx]
            if skip:
                top_nz[mx] = left_nz = 0
                if not i4:
                    top_dc[mx] = left_dc = 0
                continue
            if not i4:
                nz = put_tokens(e, bands[1], top_dc[mx] + left_dc, 0, levels[24])
                top_dc[mx] = left_dc = int(nz > 0)
                first_k, ac = 1, bands[0]
            else:
                first_k, ac = 0, bands[3]
            tnz, lnz = top_nz[mx] & 0x0F, left_nz & 0x0F
            for y in range(4):
                lb = lnz & 1
                for x in range(4):
                    nz = put_tokens(e, ac, lb + (tnz & 1), first_k, levels[4 * y + x])
                    lb = int(nz > first_k)
                    tnz = (tnz >> 1) | (lb << 7)
                tnz >>= 4
                lnz = (lnz >> 1) | (lb << 7)
            out_t, out_l = tnz, lnz >> 4
            for ch in (0, 2):
                tnz, lnz = top_nz[mx] >> (4 + ch), left_nz >> (4 + ch)
                for y in range(2):
                    lb = lnz & 1
                    for x in range(2):
                        nz = put_tokens(e, bands[2], lb + (tnz & 1), 0, levels[16 + 2 * ch + 2 * y + x])
                        lb = int(nz > 0)
                        tnz = (tnz >> 1) | (lb << 3)
                    tnz >>= 2
                    lnz = (lnz >> 1) | (lb << 5)
                out_t |= (tnz << 4) << ch
                out_l |= (lnz & 0xF0) << ch
            top_nz[mx], left_nz = out_t, out_l
    streams = [t.finish() for t in token]
    sizes = b"".join(len(s).to_bytes(3, "little") for s in streams[:-1])
    tag = (len(first) << 5) | (1 << 4)  # a shown key frame, version 0
    head = tag.to_bytes(3, "little") + b"\x9d\x01\x2a" + struct.pack("<HH", w, h)
    return riff(chunk(b"VP8 ", head + first + sizes + b"".join(streams)))


VP8_CASES = {
    "normal": dict(),
    "simple": dict(simple=1, level=30),
    "simple_sharp": dict(simple=1, level=45, sharpness=6),
    "sharpness_3": dict(level=50, sharpness=3),
    "sharpness_7": dict(level=63, sharpness=7),
    "deltas": dict(level=25, ref_delta=-9, mode_delta=14),
    "no_filter": dict(level=0),
    "segments_delta": dict(segments=(False, (-10, 0, 15, 30), (-20, 0, 10, 30))),
    "segments_absolute": dict(segments=(True, (5, 40, 90, 127), (0, 12, 40, 63)), level=10),
    "partitions_2": dict(parts=2),
    "partitions_8": dict(parts=8, skip_prob=90),
    "skips": dict(skip_prob=40),
    "quant_deltas": dict(base_q=60, dq=(3, -5, 7, -2, 4)),
    "big_levels": dict(base_q=0, big=600),
}


@pytest.mark.parametrize("case", sorted(VP8_CASES))
def test_vp8_header_variants(case):
    """Key frames this test encodes with what libwebp's encoder does not
    vary: the simple loop filter, sharpness, the loop-filter deltas, no
    filter, segment maps with absolute and relative values, several token
    partitions, skipped macroblocks, quantizer deltas and levels of every
    token category, at sizes off the macroblock grid."""
    for w, h, seed in ((35, 21, 1), (48, 32, 2)):
        assert_decodes_as_pil(encode_vp8(w, h, seed, **VP8_CASES[case]))
