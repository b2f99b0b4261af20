"""The port's GIF decoder (``inference/image_gif.decode_gif``) against
PIL's ``Image.open(...).convert("RGB")``, bit for bit: files PIL writes
(palette, grey and RGB images, interlaced or not, animations' first
frames, transparency), and files ``encode_gif`` below writes for what
PIL's encoder does not (local tables, descriptors off the screen's
origin or past its edge, identity grey tables, indices past a short
table, an LZW table that fills to 4,096 entries without a clear code,
an early end code, minimum code sizes 2-8). Truncated and corrupt files
raise saying what is wrong.
"""

import io

import numpy as np
import pytest
from PIL import Image

from pipelinerl_tpu_torch.inference import image_pipeline as ip
from pipelinerl_tpu_torch.inference.image_gif import decode_gif


def pil_rgb(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def assert_decodes_as_pil(data: bytes) -> np.ndarray:
    want = pil_rgb(data)
    got = decode_gif(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ip.decode_image(data), want)
    return got


def pil_gif(image: Image.Image, **kw) -> bytes:
    buf = io.BytesIO()
    image.save(buf, "GIF", **kw)
    return buf.getvalue()


def noise(h, w, seed, channels=3):
    return np.random.default_rng(seed).integers(0, 256, (h, w, channels), dtype=np.uint8)


# -- an encoder for what PIL's does not write ----------------------------------


def lzw_encode_gif(indices: bytes, min_bits: int, clear_when_full: bool = True, end: bool = True) -> bytes:
    """GIF's LZW of ``indices``: codes LSB first, widened as the decoder
    widens them; a full table is cleared, or kept (``clear_when_full``
    false) with no more entries; the end code unless ``end`` is false."""
    clear = 1 << min_bits
    out, acc, nbits = bytearray(), 0, 0
    width = min_bits + 1

    def put(code):
        nonlocal acc, nbits
        acc |= code << nbits
        nbits += width
        while nbits >= 8:
            out.append(acc & 255)
            acc >>= 8
            nbits -= 8

    def reset():
        nonlocal table, width, dec_len, first
        table = {bytes([i]): i for i in range(clear)}
        width, dec_len, first = min_bits + 1, clear + 2, True

    table: dict = {}
    dec_len = first = width = 0
    reset()
    put(clear)

    def emit(code):
        nonlocal width, dec_len, first
        put(code)
        if not first and dec_len < 4096:  # the decoder appends after this code
            dec_len += 1
            if dec_len == 1 << width and width < 12:
                width += 1
        first = False

    w = b""
    for px in indices:
        wc = w + bytes([px])
        if wc in table:
            w = wc
            continue
        emit(table[w])
        if len(table) + 2 < 4096:
            table[wc] = len(table) + 2
        elif clear_when_full:
            put(clear)
            reset()
        w = bytes([px])
    if w:
        emit(table[w])
    if end:
        put(clear + 1)
    if nbits:
        out.append(acc & 255)
    return bytes(out)


def sub_blocks(data: bytes) -> bytes:
    return b"".join(bytes([len(data[i : i + 255])]) + data[i : i + 255] for i in range(0, len(data), 255)) + b"\0"


def encode_gif(indices: np.ndarray, *, screen=None, offset=(0, 0), global_table=None, local_table=None,
               interlace=False, transparency=None, min_bits=8, version=b"GIF89a", **lzw) -> bytes:
    """A one-frame GIF of ``indices`` [h, w] at ``offset`` (x, y) on a
    ``screen`` (w, h), its tables [2^k, 3] global and/or local."""
    h, w = indices.shape
    sw, sh = screen or (w + offset[0], h + offset[1])

    def table_flags(t):
        return 0 if t is None else 0x80 | (int(np.log2(len(t))) - 1)

    head = version + sw.to_bytes(2, "little") + sh.to_bytes(2, "little") + bytes([table_flags(global_table), 0, 0])
    if global_table is not None:
        head += np.asarray(global_table, np.uint8).tobytes()
    if transparency is not None:
        head += b"\x21\xf9\x04" + bytes([1, 0, 0, transparency, 0])
    rows = indices
    if interlace:
        order = np.concatenate([np.arange(0, h, 8), np.arange(4, h, 8), np.arange(2, h, 4), np.arange(1, h, 2)])
        rows = indices[order]
    desc = b"\x2c" + b"".join(v.to_bytes(2, "little") for v in (*offset, w, h))
    desc += bytes([table_flags(local_table) | (0x40 if interlace else 0)])
    if local_table is not None:
        desc += np.asarray(local_table, np.uint8).tobytes()
    data = lzw_encode_gif(rows.astype(np.uint8).tobytes(), min_bits, **lzw)
    return head + desc + bytes([min_bits]) + sub_blocks(data) + b"\x3b"


def table(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (n, 3), dtype=np.uint8)


GREY = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, axis=1)


# -- files PIL writes ----------------------------------------------------------


@pytest.mark.parametrize("interlace", [False, True])
@pytest.mark.parametrize("mode", ["RGB", "P", "L", "1"])
@pytest.mark.parametrize("size", [(1, 1), (17, 9), (64, 48), (200, 131)])
def test_pil_written_files(mode, size, interlace):
    """PIL's own files: an RGB image quantized to a palette, palette,
    grey (an identity grey table: PIL reads it as "L") and bilevel
    images, interlaced where PIL interlaces (16 rows or more)."""
    pixels = noise(size[1], size[0], size[0] * size[1])
    image = Image.fromarray(pixels)
    image = image.convert(mode) if mode != "P" else image.quantize(37)
    assert_decodes_as_pil(pil_gif(image, interlace=interlace))


def test_first_frame_of_an_animation_with_transparency():
    frames = [Image.fromarray(noise(40, 52, s)).quantize(64) for s in range(3)]
    buf = io.BytesIO()
    frames[0].save(buf, "GIF", save_all=True, append_images=frames[1:], duration=80, loop=0, transparency=5,
                   disposal=2)
    assert Image.open(io.BytesIO(buf.getvalue())).n_frames == 3
    assert_decodes_as_pil(buf.getvalue())


# -- files written here --------------------------------------------------------


def indices(h, w, n, seed):
    return np.random.default_rng(seed).integers(0, n, (h, w), dtype=np.uint8)


@pytest.mark.parametrize("case", ["global", "local", "local_over_global", "offset", "past_the_screen",
                                  "offset_transparency", "grey_global", "grey_local", "no_table", "short_table",
                                  "gif87a", "interlaced_offset"])
def test_tables_and_placement(case):
    """Which table the frame takes (its local one over the global one),
    PIL's "L" for identity grey tables and for no table (a grey local
    table leaves the global one in force), indices past a short table
    (black), the frame off the screen's
    origin (the rest 0, or the transparency index) and past its edge (the
    screen grows)."""
    px = indices(23, 31, 16, 1)
    kw = {"global": dict(global_table=table(16, 2)), "local": dict(local_table=table(16, 3)),
          "local_over_global": dict(global_table=table(16, 2), local_table=table(32, 3)),
          "offset": dict(global_table=table(16, 2), offset=(5, 7), screen=(50, 40)),
          "past_the_screen": dict(global_table=table(16, 2), offset=(20, 30), screen=(40, 40)),
          "offset_transparency": dict(global_table=table(16, 2), offset=(3, 2), screen=(40, 30), transparency=9),
          "grey_global": dict(global_table=GREY), "grey_local": dict(global_table=table(16, 2), local_table=GREY),
          "no_table": dict(), "short_table": dict(global_table=table(4, 5)),
          "gif87a": dict(global_table=table(16, 2), version=b"GIF87a"),
          "interlaced_offset": dict(local_table=table(16, 4), interlace=True, offset=(1, 1), screen=(33, 25))}[case]
    data = encode_gif(px, **kw)
    got = assert_decodes_as_pil(data)
    x0, y0 = kw.get("offset", (0, 0))
    tab = kw.get("local_table", kw.get("global_table")) if case != "grey_local" else kw["global_table"]
    if case not in ("short_table", "no_table"):
        want = (GREY if tab is None else np.asarray(tab))[px]
        np.testing.assert_array_equal(got[y0 : y0 + 23, x0 : x0 + 31], want)


@pytest.mark.parametrize("min_bits", [2, 3, 5, 8])
@pytest.mark.parametrize("interlace", [False, True])
def test_code_sizes_and_interlace(min_bits, interlace):
    n = 1 << min_bits
    px = indices(37, 29, min(n, 256), min_bits)
    data = encode_gif(px, global_table=table(n, 7), min_bits=min_bits, interlace=interlace)
    np.testing.assert_array_equal(assert_decodes_as_pil(data), table(n, 7)[px])


@pytest.mark.parametrize("clear_when_full", [True, False])
def test_full_table(clear_when_full):
    """Noise fills the 4,096-entry table: cleared, or kept full without
    a clear code, when the table stops growing and codes stay 12 bits."""
    px = indices(120, 160, 256, 8)
    data = encode_gif(px, global_table=table(256, 9), clear_when_full=clear_when_full)
    np.testing.assert_array_equal(assert_decodes_as_pil(data), table(256, 9)[px])


def test_early_end_code_raises():
    """An end code before the last pixel: PIL waits for more data and
    reports the file truncated, and so does the port."""
    px = indices(10, 12, 16, 10)
    data = bytearray(encode_gif(px, global_table=table(16, 11), min_bits=4))
    full = lzw_encode_gif(px.tobytes(), 4)
    partial = lzw_encode_gif(px.tobytes()[:50], 4)
    start = data.index(bytes([4]) + sub_blocks(full))
    data[start:] = bytes([4]) + sub_blocks(partial) + b"\x3b"
    with pytest.raises(OSError, match="truncated"):
        pil_rgb(bytes(data))
    with pytest.raises(ValueError, match="truncated GIF: the image data ends after 50 of its 120 pixels"):
        decode_gif(bytes(data))


def test_larger_image():
    """A chart-sized palette image: 300x400, interlaced."""
    image = Image.fromarray(np.kron(noise(30, 40, 12), np.ones((10, 10, 1), np.uint8))).quantize(200)
    assert_decodes_as_pil(pil_gif(image, interlace=True))


# -- refusals ------------------------------------------------------------------


@pytest.mark.parametrize("cut", [0.05, 0.3, 0.6, 0.9, 0.99])
def test_truncated_files_raise(cut):
    data = encode_gif(indices(40, 40, 64, 13), global_table=table(64, 14))
    short = data[: int(len(data) * cut)]
    with pytest.raises(OSError):
        pil_rgb(short)
    with pytest.raises(ValueError, match="truncated GIF"):
        decode_gif(short)


def test_corrupt_files_raise_saying_what_is_wrong():
    px = indices(8, 8, 4, 15)
    data = encode_gif(px, global_table=table(4, 16), min_bits=2)
    start = data.index(bytes([2, len(lzw_encode_gif(px.tobytes(), 2))])) + 2
    bad = bytearray(data)
    bad[start] = 0b111_100  # clear (4), then code 7 past the table's 6 entries
    with pytest.raises(ValueError, match="corrupt GIF: LZW code"):
        decode_gif(bytes(bad))
    with pytest.raises(ValueError, match="corrupt GIF: block type"):
        decode_gif(data[:13 + 12] + b"\x99" + data[13 + 12 :])
    with pytest.raises(ValueError, match="trailer comes before any image"):
        decode_gif(data[:13 + 12] + b"\x3b")
    with pytest.raises(ValueError, match="not a GIF"):
        decode_gif(b"GIF90a" + data[6:])
