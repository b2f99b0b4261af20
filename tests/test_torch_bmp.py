"""The port's BMP decoder (``inference/image_bmp.decode_bmp``) against
PIL's ``Image.open(...).convert("RGB")``, bit for bit: files PIL writes
(1-bit, grey, palette, RGB and RGBA images), and files ``encode_bmp``
below writes for the rest of what PIL's ``BmpImagePlugin`` reads: every
header size (12, 40, 52, 56, 64, 108, 124), 1-, 4-, 8-, 16-, 24- and
32-bit pixels, ``BI_RGB``, ``BI_RLE8``, ``BI_RLE4`` and ``BI_BITFIELDS``
with each mask layout PIL supports, bottom-up and top-down rows, short
palettes. What PIL refuses (``ALPHABITFIELDS``, other masks and depths,
JPEG and PNG compression) the port refuses; truncated files raise saying
what is wrong.
"""

import io
import struct

import numpy as np
import pytest
from PIL import Image

from pipelinerl_tpu_torch.inference import image_pipeline as ip
from pipelinerl_tpu_torch.inference.image_bmp import decode_bmp


def pil_rgb(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def assert_decodes_as_pil(data: bytes) -> np.ndarray:
    want = pil_rgb(data)
    got = decode_bmp(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ip.decode_image(data), want)
    return got


def noise(h, w, seed, high=256, channels=None):
    shape = (h, w) if channels is None else (h, w, channels)
    return np.random.default_rng(seed).integers(0, high, shape, dtype=np.uint8)


def palette(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (n, 3), dtype=np.uint8)


# -- an encoder for what PIL's does not write ----------------------------------


def rle_encode(rows: np.ndarray, rle4: bool) -> bytes:
    """RLE8/RLE4 of sample rows [h, w] in file order: runs of a value (a
    nibble pair under RLE4), absolute runs of three or more distinct
    samples, an end of line after each row and an end of bitmap; the
    absolute runs padded to 16 bits."""
    out = bytearray()
    for row in rows.tolist():
        x = 0
        while x < len(row):
            run = 1
            while x + run < len(row) and run < 255 and row[x + run] == row[x]:
                run += 1
            if run >= 2 or len(row) - x < 3:
                n = run if run >= 2 else 1
                out += bytes([n, (row[x] << 4) | row[x] if rle4 else row[x]])
                x += n
                continue
            n = 3
            while x + n < len(row) and n < 255 and row[x + n] != row[x + n - 1]:
                n += 1
            chunk = row[x : x + n]
            if rle4:
                if len(chunk) % 2:
                    chunk = chunk + [0]
                body = bytes((chunk[i] << 4) | chunk[i + 1] for i in range(0, len(chunk), 2))
            else:
                body = bytes(chunk)
            out += bytes([0, n]) + body + (b"\0" if len(body) % 2 else b"")
            x += n
        out += b"\0\0"
    return bytes(out) + b"\0\1"


def encode_bmp(samples: np.ndarray, bits: int, *, header: int = 40, compression: int = 0, table=None, masks=None,
               top_down: bool = False, colors: int | None = None, offset: int | None = None) -> bytes:
    """A BMP of ``samples`` ([h, w] indices at 1-8 bits, [h, w] 16-bit
    values at 16 bits, [h, w, 3 or 4] bytes at 24 and 32 bits, in the
    file's byte order), a ``header``-byte info header, ``table`` RGB
    entries as the palette, ``masks`` written after a 40-byte header or
    inside a longer one."""
    h, w = samples.shape[:2]
    rows = samples if top_down else samples[::-1]
    if compression in (1, 2):
        pixels = rle_encode(rows, compression == 2)
    else:
        stride = ((w * bits + 31) >> 3) & ~3
        if bits < 8:
            bitsarr = np.unpackbits(rows.astype(np.uint8)[..., None], axis=-1)[..., 8 - bits :].reshape(h, -1)
            packed = np.packbits(bitsarr, axis=1)
        elif bits == 16:
            packed = rows.astype("<u2").view(np.uint8).reshape(h, -1)
        else:
            packed = rows.reshape(h, -1)
        padded = np.zeros((h, stride), np.uint8)
        padded[:, : packed.shape[1]] = packed
        pixels = padded.tobytes()
    pal = b""
    if table is not None:
        entry = 3 if header == 12 else 4
        pal = b"".join(bytes([b, g, r] + [0] * (entry - 3)) for r, g, b in np.asarray(table).tolist())
    if header == 12:
        info = struct.pack("<IHHHH", 12, w, h, 1, bits)
    else:
        info = struct.pack("<IiiHHIIiiII", header, w, -h if top_down else h, 1, bits, compression, len(pixels),
                           2835, 2835, colors if colors is not None else (0 if table is None else len(table)), 0)
        extra = b""
        if masks is not None and header >= 52:
            extra = struct.pack("<" + "I" * len(masks), *masks)[: header - 40]
        info += extra + b"\0" * (header - 40 - len(extra))
        if masks is not None and header == 40:
            info += struct.pack("<III", *masks[:3])
    start = 14 + len(info) + len(pal)
    head = b"BM" + struct.pack("<IHHI", start + len(pixels), 0, 0, start if offset is None else offset)
    return head + info + pal + pixels


# -- files PIL writes ----------------------------------------------------------


@pytest.mark.parametrize("mode", ["1", "L", "P", "RGB", "RGBA"])
@pytest.mark.parametrize("size", [(1, 1), (17, 9), (31, 30), (64, 48)])
def test_pil_written_files(mode, size):
    image = Image.fromarray(noise(size[1], size[0], size[0] + size[1], channels=4), "RGBA")
    image = image.convert(mode) if mode != "P" else image.convert("RGB").quantize(50)
    buf = io.BytesIO()
    image.save(buf, "BMP")
    assert_decodes_as_pil(buf.getvalue())


# -- files written here --------------------------------------------------------

HEADERS = [12, 40, 52, 56, 64, 108, 124]


@pytest.mark.parametrize("header,top_down", [(h, t) for h in HEADERS for t in (False, True) if h != 12 or not t])
@pytest.mark.parametrize("bits", [1, 4, 8, 24])
def test_headers_and_depths(header, bits, top_down):
    """Palette images at 1, 4 and 8 bits (3-byte entries under the OS/2
    1.x header) and 24-bit BGR, with every header, bottom-up or top-down
    (which the 12-byte header, its sizes unsigned, cannot say)."""
    h, w = 13, 21
    if bits == 24:
        got = assert_decodes_as_pil(encode_bmp(noise(h, w, bits, channels=3), 24, header=header, top_down=top_down))
        return
    px = noise(h, w, bits, high=1 << bits)
    tab = palette(1 << bits, header)
    got = assert_decodes_as_pil(encode_bmp(px, bits, header=header, table=tab, top_down=top_down))
    np.testing.assert_array_equal(got, tab[px])


@pytest.mark.parametrize("case", ["555", "bitfields_565", "bitfields_555", "bitfields_24", "raw_32",
                                  *(f"bitfields_32_{i}" for i in range(8)), "bitfields_32_header_56",
                                  "bitfields_32_header_124"])
def test_colour_layouts(case):
    """16-bit 5-5-5 (raw) and the bitfield layouts PIL supports: 5-6-5 and
    5-5-5, BGR at 24 bits, and the byte-aligned 32-bit masks with and
    without alpha (the colour bytes kept, the alpha dropped)."""
    h, w = 11, 19
    if case in ("555", "bitfields_565", "bitfields_555"):
        px = np.random.default_rng(1).integers(0, 1 << 16, (h, w)).astype(np.uint16)
        masks = {"555": None, "bitfields_565": (0xF800, 0x7E0, 0x1F), "bitfields_555": (0x7C00, 0x3E0, 0x1F)}[case]
        assert_decodes_as_pil(encode_bmp(px, 16, compression=0 if masks is None else 3, masks=masks))
        return
    if case == "bitfields_24":
        assert_decodes_as_pil(encode_bmp(noise(h, w, 2, channels=3), 24, compression=3,
                                         masks=(0xFF0000, 0xFF00, 0xFF)))
        return
    if case == "raw_32":
        assert_decodes_as_pil(encode_bmp(noise(h, w, 3, channels=4), 32))
        return
    layouts = [(0xFF0000, 0xFF00, 0xFF, 0x0), (0xFF000000, 0xFF0000, 0xFF00, 0x0), (0xFF000000, 0xFF00, 0xFF, 0x0),
               (0xFF000000, 0xFF0000, 0xFF00, 0xFF), (0xFF, 0xFF00, 0xFF0000, 0xFF000000),
               (0xFF0000, 0xFF00, 0xFF, 0xFF000000), (0xFF000000, 0xFF00, 0xFF, 0xFF0000), (0x0, 0x0, 0x0, 0x0)]
    header = {"bitfields_32_header_56": 56, "bitfields_32_header_124": 124}.get(case, 108)
    masks = layouts[int(case[-1])] if case[-1].isdigit() and header == 108 else layouts[5 if header == 56 else 3]
    assert_decodes_as_pil(encode_bmp(noise(h, w, 4, channels=4), 32, header=header, compression=3, masks=masks))


@pytest.mark.parametrize("rle4", [False, True])
@pytest.mark.parametrize("size", [(1, 1), (9, 14), (37, 23)])
def test_rle(rle4, size):
    """RLE8 and RLE4: runs, absolute runs (odd lengths, padded), ends of
    line and of bitmap. PIL reads an odd RLE4 absolute run one sample
    short and the port follows it, so only RLE8 is also held to the
    samples written."""
    h, w = size
    bits = 4 if rle4 else 8
    base = noise(h, w, h + w, high=1 << bits)
    px = np.where(np.random.default_rng(5).random((h, w)) < 0.6, base[:, :1], base)  # long runs and noise
    tab = palette(1 << bits, 6)
    data = encode_bmp(px, bits, compression=2 if rle4 else 1, table=tab)
    got = assert_decodes_as_pil(data)
    if not rle4:
        np.testing.assert_array_equal(got, tab[px])


def test_rle_delta_reads_four_bytes_as_pil_does():
    """A delta escape: PIL reads two bytes, then takes the next two as the
    offsets, and the port does the same."""
    w, h = 8, 3
    body = bytes([4, 1]) + bytes([0, 2, 9, 9, 2, 1]) + bytes([2, 3, 0, 0]) + bytes([8, 5, 0, 0, 8, 6, 0, 1])
    info = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 8, 1, len(body), 0, 0, 16, 0)
    tab = palette(16, 7)
    pal = b"".join(bytes([b, g, r, 0]) for r, g, b in tab.tolist())
    start = 14 + 40 + len(pal)
    data = b"BM" + struct.pack("<IHHI", start + len(body), 0, 0, start) + info + pal + body
    assert_decodes_as_pil(data)


@pytest.mark.parametrize("case", ["grey_8", "black_white_1", "black_white_8", "short_palette", "offset_at_header",
                                  "colors_field"])
def test_palette_rules(case):
    """A grey-ramp palette: PIL reads the samples as "L" ("1" for a
    black-and-white pair, even over 8-bit samples); indices past a short
    palette read black; a data offset that points at the palette skips
    it; a colour count below the depth's."""
    h, w = 10, 16
    if case == "grey_8":
        data = encode_bmp(noise(h, w, 1), 8, table=np.repeat(np.arange(256)[:, None], 3, 1))
    elif case == "black_white_1":
        data = encode_bmp(noise(h, w, 2, high=2), 1, table=[[0, 0, 0], [255, 255, 255]])
    elif case == "black_white_8":
        data = encode_bmp(noise(h, w, 3, high=2), 8, table=[[0, 0, 0], [255, 255, 255]], colors=2)
    elif case == "short_palette":
        data = encode_bmp(noise(h, w, 4, high=40), 8, table=palette(20, 5), colors=20)
    elif case == "offset_at_header":
        data = encode_bmp(noise(h, w, 5, high=256), 8, table=palette(256, 6), offset=14 + 40)
    else:
        data = encode_bmp(noise(h, w, 6, high=16), 8, table=palette(16, 7), colors=16)
    assert_decodes_as_pil(data)


@pytest.mark.parametrize("case", ["alphabitfields", "jpeg", "png", "bitfields_10bit", "bits_2", "header_16"])
def test_refused_as_pil_refuses(case):
    h, w = 4, 4
    if case == "alphabitfields":
        data = encode_bmp(noise(h, w, 1, channels=4), 32, header=56, compression=6,
                          masks=(0xFF0000, 0xFF00, 0xFF, 0xFF000000))
    elif case in ("jpeg", "png"):
        data = encode_bmp(noise(h, w, 2, channels=3), 24, compression=4 if case == "jpeg" else 5)
    elif case == "bitfields_10bit":
        data = encode_bmp(noise(h, w, 3, channels=4), 32, header=108, compression=3,
                          masks=(0x3FF00000, 0xFFC00, 0x3FF, 0))
    elif case == "bits_2":
        data = encode_bmp(noise(h, w, 4, high=4), 2, table=palette(4, 8))
    else:
        data = bytearray(encode_bmp(noise(h, w, 5, channels=3), 24))
        data[14] = 16
        data = bytes(data)
    with pytest.raises(OSError):
        pil_rgb(data)
    with pytest.raises(ValueError, match="PIL does not open either"):
        decode_bmp(data)


def test_larger_image():
    """A chart-sized file: 300x400, 24-bit, bottom-up."""
    assert_decodes_as_pil(encode_bmp(np.kron(noise(30, 40, 9, channels=3), np.ones((10, 10, 1), np.uint8)), 24))


# -- refusals ------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["raw", "rle8"])
@pytest.mark.parametrize("cut", [0.05, 0.5, 0.9, 0.99])
def test_truncated_files_raise(kind, cut):
    px = noise(20, 24, 10, high=16)
    data = encode_bmp(px, 8, table=palette(16, 11), compression=1 if kind == "rle8" else 0)
    short = data[: int(len(data) * cut)]
    with pytest.raises((OSError, ValueError)):
        pil_rgb(short)
    with pytest.raises(ValueError, match="truncated BMP"):
        decode_bmp(short)


def test_not_a_bmp():
    with pytest.raises(ValueError, match="not a BMP"):
        decode_bmp(b"BX" + bytes(60))
