"""The port's TIFF decoder (``inference/image_tiff.decode_tiff``) against
PIL's ``Image.open(...).convert("RGB")``, bit for bit: files PIL writes
(through libtiff: none, PackBits, LZW, Adobe and old Deflate, JPEG; the
horizontal predictor; grey, palette, RGB, RGBA, CMYK, 16-bit grey and
bilevel images; the orientations PIL applies on load), and files
``encode_tiff`` below writes for the rest: tiles, planar configuration 2,
BigTIFF, both byte orders, 16-bit colour, associated and unassociated
alpha, 1-, 2- and 4-bit grey and palettes, WhiteIsZero, fill order 2,
JPEG tiles. Float and signed samples, CCITT and the other compressions
raise naming ROADMAP item 16; truncated and corrupt files raise saying
what is wrong.
"""

import io
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from pipelinerl_tpu_torch.inference import image_pipeline as ip
from pipelinerl_tpu_torch.inference.image_tiff import decode_tiff


def pil_rgb(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def assert_decodes_as_pil(data: bytes) -> np.ndarray:
    want = pil_rgb(data)
    got = decode_tiff(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ip.decode_image(data), want)
    return got


def noise(shape, seed, high=256, dtype=np.uint8):
    return np.random.default_rng(seed).integers(0, high, shape).astype(dtype)


def pil_tiff(image: Image.Image, **kw) -> bytes:
    buf = io.BytesIO()
    image.save(buf, "TIFF", **kw)
    return buf.getvalue()


# -- an encoder for what PIL's does not write ----------------------------------


def lzw_encode_tiff(data: bytes) -> bytes:
    """TIFF's LZW: codes MSB first from 9 bits, widened one entry early as
    libtiff's decoder widens them, a clear code before the table fills."""
    out, acc, nbits = bytearray(), 0, 0
    width = 9
    table: dict = {}
    dec_len = first = 0

    def put(code):
        nonlocal acc, nbits
        acc = (acc << width) | code
        nbits += width
        while nbits >= 8:
            nbits -= 8
            out.append((acc >> nbits) & 255)
        acc &= (1 << nbits) - 1

    def clear():
        nonlocal table, width, dec_len, first
        put(256)
        table = {bytes([i]): i for i in range(256)}
        width, dec_len, first = 9, 258, True

    def emit(code):
        nonlocal width, dec_len, first
        put(code)
        if not first:
            dec_len += 1
            if dec_len + 1 == 1 << width and width < 12:
                width += 1
        first = False

    clear()
    w = b""
    for byte in data:
        wc = w + bytes([byte])
        if wc in table:
            w = wc
            continue
        emit(table[w])
        table[wc] = len(table) + 2
        if len(table) + 2 >= 4093:
            clear()
        w = bytes([byte])
    if w:
        emit(table[w])
    put(257)
    if nbits:
        out.append((acc << (8 - nbits)) & 255)
    return bytes(out)


def packbits(data: bytes) -> bytes:
    out, i = bytearray(), 0
    while i < len(data):
        run = 1
        while i + run < len(data) and run < 128 and data[i + run] == data[i]:
            run += 1
        if run > 1:
            out += bytes([257 - run, data[i]])
            i += run
            continue
        j = i + 1
        while j < len(data) and j - i < 128 and (j + 1 >= len(data) or data[j + 1] != data[j]):
            j += 1
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


COMPRESS = {1: lambda b: b, 5: lzw_encode_tiff, 8: zlib.compress, 32946: zlib.compress, 32773: packbits}


def predict(rows: np.ndarray, spp: int) -> np.ndarray:
    """Horizontal differencing of sample rows [rows, width * spp]."""
    x = rows.reshape(rows.shape[0], -1, spp).astype(np.int64)
    d = x.copy()
    d[:, 1:] = x[:, 1:] - x[:, :-1]
    return (d & (0xFFFF if rows.dtype.itemsize == 2 else 0xFF)).astype(rows.dtype).reshape(rows.shape)


def encode_tiff(samples: np.ndarray, *, bits: int = 8, photometric: int = 2, compression: int = 1, predictor=1,
                planar: int = 1, tile=None, rows_per_strip=None, bigtiff=False, order="<", extra=(), colormap=None,
                sample_format=None, orientation=None, fill_order=None, jpeg_chunks=None, subsampling=None) -> bytes:
    """A TIFF of ``samples`` [h, w] or [h, w, spp] (16-bit values as
    uint16; 1-4 bits as small integers), in strips of ``rows_per_strip``
    or tiles (tw, th), chunky or planar, classic or BigTIFF, in byte order
    ``order``; ``jpeg_chunks`` (a function of a chunk's pixels) writes
    each chunk as a JPEG."""
    img = samples if samples.ndim == 3 else samples[..., None]
    h, w, spp = img.shape
    tw, th = tile if tile else (w, rows_per_strip or h)
    across, down = -(-w // tw), -(-h // th)
    planes = spp if planar == 2 else 1
    chunks = []
    for plane in range(planes):
        for cy in range(down):
            for cx in range(across):
                rows = th if tile else min(th, h - cy * th)
                block = np.zeros((rows, tw, spp), img.dtype)
                part = img[cy * th : cy * th + rows, cx * tw : cx * tw + tw]
                block[: part.shape[0], : part.shape[1]] = part
                if jpeg_chunks is not None:
                    chunks.append(jpeg_chunks(block))
                    continue
                if planar == 2:
                    block = block[..., plane : plane + 1]
                per = block.shape[-1]
                if bits < 8:
                    flat = block.reshape(rows, tw * per).astype(np.uint8)
                    bitsarr = np.unpackbits(flat[..., None], axis=-1)[..., 8 - bits :].reshape(rows, -1)
                    raw = np.packbits(bitsarr, axis=1).tobytes()
                else:
                    flat = block.reshape(rows, tw * per)
                    if predictor == 2:
                        flat = predict(flat, per)
                    raw = flat.astype(np.dtype(order + ("u2" if bits == 16 else "u1"))).tobytes()
                if fill_order == 2:
                    raw = np.packbits(np.unpackbits(np.frombuffer(raw, np.uint8)).reshape(-1, 8)[:, ::-1]).tobytes()
                chunks.append(COMPRESS[compression](raw))
    entries = {256: (4, [w]), 257: (4, [h]), 258: (3, [bits] * spp), 259: (3, [compression]), 262: (3, [photometric]),
               277: (3, [spp]), 284: (3, [planar])}
    if tile:
        entries.update({322: (3, [tw]), 323: (3, [th])})
    else:
        entries[278] = (4, [th])
    if predictor != 1:
        entries[317] = (3, [predictor])
    if extra:
        entries[338] = (3, list(extra))
    if colormap is not None:
        entries[320] = (3, list(np.asarray(colormap, np.int64).T.ravel()))
    if sample_format is not None:
        entries[339] = (3, [sample_format] * spp)
    if orientation is not None:
        entries[274] = (3, [orientation])
    if fill_order is not None:
        entries[266] = (3, [fill_order])
    if subsampling is not None:
        entries[530] = (3, list(subsampling))
    off_tag, count_tag = (324, 325) if tile else (273, 279)
    long_type, off_size = (16, 8) if bigtiff else (4, 4)
    head_size = 16 if bigtiff else 8
    body = bytearray()
    offsets = []
    for c in chunks:
        offsets.append(head_size + len(body))
        body += c
        if len(body) % 2:
            body += b"\0"
    entries[off_tag] = (long_type, offsets)
    entries[count_tag] = (long_type, [len(c) for c in chunks])
    codes = {3: "H", 4: "I", 16: "Q"}
    extra_data = bytearray()
    ifd_at = head_size + len(body)
    n = len(entries)
    entry_size, inline = (20, 8) if bigtiff else (12, 4)
    data_at = ifd_at + (8 if bigtiff else 2) + n * entry_size + off_size
    ifd = struct.pack(order + ("Q" if bigtiff else "H"), n)
    for tag in sorted(entries):
        kind, values = entries[tag]
        packed = struct.pack(order + codes[kind] * len(values), *values)
        if len(packed) <= inline:
            field = packed.ljust(inline, b"\0")
        else:
            field = struct.pack(order + ("Q" if bigtiff else "I"), data_at + len(extra_data))
            extra_data += packed
        ifd += struct.pack(order + ("HHQ" if bigtiff else "HHI"), tag, kind, len(values)) + field
    ifd += bytes(off_size)
    magic = (b"II" if order == "<" else b"MM") + struct.pack(order + "H", 43 if bigtiff else 42)
    header = magic + (struct.pack(order + "HHQ", 8, 0, ifd_at) if bigtiff else struct.pack(order + "I", ifd_at))
    return header + bytes(body) + ifd + bytes(extra_data)


def colormap(n: int, seed: int) -> np.ndarray:
    return noise((n, 3), seed, high=65536, dtype=np.int64)


# -- files PIL writes ----------------------------------------------------------

PIL_COMPRESSIONS = ["raw", "packbits", "tiff_lzw", "tiff_adobe_deflate", "tiff_deflate"]


@pytest.mark.parametrize("compression", PIL_COMPRESSIONS)
@pytest.mark.parametrize("mode", ["1", "L", "P", "RGB", "RGBA", "CMYK", "I;16", "LA"])
def test_pil_written_files(mode, compression):
    image = Image.fromarray(noise((29, 37, 4), 1), "RGBA")
    image = image.convert("RGB").quantize(40) if mode == "P" else image.convert(mode) if mode != "I;16" else \
        Image.fromarray(noise((29, 37), 2, high=1000, dtype=np.uint16))
    assert_decodes_as_pil(pil_tiff(image, compression=compression))


@pytest.mark.parametrize("compression", ["tiff_lzw", "tiff_adobe_deflate"])
@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA", "I;16"])
def test_pil_written_predictor(mode, compression):
    """libtiff's horizontal differencing (predictor 2), 8- and 16-bit."""
    image = Image.fromarray(noise((33, 45), 3, high=60000, dtype=np.uint16)) if mode == "I;16" else \
        Image.fromarray(noise((33, 45, 4), 3), "RGBA").convert(mode)
    data = pil_tiff(image, compression=compression, tiffinfo={317: 2})
    assert Image.open(io.BytesIO(data)).tag_v2.get(317) == 2
    assert_decodes_as_pil(data)


@pytest.mark.parametrize("mode", ["RGB", "L"])
@pytest.mark.parametrize("quality", [50, 90])
def test_pil_written_jpeg(mode, quality):
    """JPEG-in-TIFF as libtiff writes it: strips that ``JPEGTables``
    completes, decoded as libtiff hands them to libjpeg-turbo."""
    y, x = np.mgrid[0:70, 0:90]
    pixels = np.clip(np.stack([x * 3, y * 3, (x + y) * 2], -1) + noise((70, 90, 3), 4, high=20), 0, 255).astype(
        np.uint8)
    data = pil_tiff(Image.fromarray(pixels).convert(mode), compression="jpeg", quality=quality)
    assert Image.open(io.BytesIO(data)).tag_v2.get(347)
    assert_decodes_as_pil(data)


@pytest.mark.parametrize("compression", ["raw", "tiff_lzw"])
@pytest.mark.parametrize("orientation", range(1, 9))
def test_orientation_applied_as_pil_applies_it(orientation, compression):
    """PIL's TIFF loader transposes by the Orientation tag (through its
    own decoder and through libtiff), and so does the port."""
    pixels = noise((7, 11, 3), 5)
    got = assert_decodes_as_pil(pil_tiff(Image.fromarray(pixels), tiffinfo={274: orientation},
                                         compression=compression))
    assert got.shape[:2] == ((11, 7) if orientation >= 5 else (7, 11))


# -- files written here --------------------------------------------------------


@pytest.mark.parametrize("compression", [1, 5, 8, 32946, 32773])
@pytest.mark.parametrize("layout", ["strips", "tiles", "planar_strips", "planar_tiles"])
def test_layouts_and_compressions(layout, compression):
    """Strips (one, and several with a short last one) and tiles (partial
    at the right and bottom edges), chunky and planar, each compression;
    with the predictor under LZW and Deflate."""
    pixels = noise((37, 45, 3), 6)
    kw = dict(compression=compression, planar=2 if layout.startswith("planar") else 1,
              predictor=2 if compression in (5, 8) else 1)
    if layout.endswith("tiles"):
        kw["tile"] = (16, 16)
    else:
        kw["rows_per_strip"] = 8
    got = assert_decodes_as_pil(encode_tiff(pixels, **kw))
    np.testing.assert_array_equal(got, pixels)


@pytest.mark.parametrize("bigtiff", [False, True])
@pytest.mark.parametrize("order", ["<", ">"])
@pytest.mark.parametrize("bits", [8, 16])
def test_bigtiff_and_byte_orders(bigtiff, order, bits):
    """Both byte orders, classic and BigTIFF; PIL does not open a
    big-endian BigTIFF (it looks for the magic in the little-endian
    place), so the port refuses one too."""
    high = 65536 if bits == 16 else 256
    pixels = noise((19, 23, 3), 7, high=high, dtype=np.uint16 if bits == 16 else np.uint8)
    data = encode_tiff(pixels, bits=bits, order=order, bigtiff=bigtiff, compression=5, predictor=2, rows_per_strip=5)
    if bigtiff and order == ">":
        with pytest.raises(OSError):
            pil_rgb(data)
        with pytest.raises(ValueError, match="big-endian BigTIFF.*PIL does not open either"):
            decode_tiff(data)
        return
    got = assert_decodes_as_pil(data)
    np.testing.assert_array_equal(got, pixels >> 8 if bits == 16 else pixels)


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("extra", [(0,), (1,), (2,), ()])
def test_alpha(bits, extra):
    """Associated alpha (RGBa: PIL divides it out), unassociated alpha,
    an unspecified extra sample, and four samples without ExtraSamples."""
    high = 65536 if bits == 16 else 256
    pixels = noise((21, 17, 4), 8, high=high, dtype=np.uint16 if bits == 16 else np.uint8)
    pixels[0, :4, 3] = [0, high - 1, 1, high // 2]
    assert_decodes_as_pil(encode_tiff(pixels, bits=bits, extra=extra, compression=8))


@pytest.mark.parametrize("case", ["rgb_8_xx", "rgba_8_x", "cmyk_16", "cmyk_8_x", "la"])
def test_more_colour_layouts(case):
    if case == "rgb_8_xx":
        data = encode_tiff(noise((9, 11, 5), 9), extra=(0, 0))
    elif case == "rgba_8_x":
        data = encode_tiff(noise((9, 11, 6), 10), extra=(2, 0, 0))
    elif case == "cmyk_16":
        data = encode_tiff(noise((9, 11, 4), 11, high=65536, dtype=np.uint16), bits=16, photometric=5)
    elif case == "cmyk_8_x":
        data = encode_tiff(noise((9, 11, 5), 12), photometric=5, extra=(0,))
    else:
        data = encode_tiff(noise((9, 11, 2), 13), photometric=1, extra=(2,))
    assert_decodes_as_pil(data)


@pytest.mark.parametrize("photometric", [0, 1, 3])
@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_grey_and_palette_depths(photometric, bits):
    """Grey (WhiteIsZero inverted) and palette images at 1, 2, 4 and 8
    bits, widths off the byte grid, in strips and with LZW."""
    px = noise((13, 19), bits, high=1 << bits)
    cmap = colormap(1 << bits, bits) if photometric == 3 else None
    got = assert_decodes_as_pil(encode_tiff(px, bits=bits, photometric=photometric, colormap=cmap, rows_per_strip=4,
                                            compression=5))
    if photometric == 3:
        np.testing.assert_array_equal(got, (cmap // 256).astype(np.uint8)[px])


@pytest.mark.parametrize("order", ["<", ">"])
@pytest.mark.parametrize("photometric", [0, 1])
def test_grey_16(order, photometric):
    """16-bit grey clips at 255; WhiteIsZero at 16 bits reads as stored,
    little-endian only: PIL has no big-endian mode for it."""
    data = encode_tiff(noise((8, 9), 14, high=700, dtype=np.uint16), bits=16, photometric=photometric, order=order)
    if photometric == 0 and order == ">":
        with pytest.raises(OSError):
            pil_rgb(data)
        with pytest.raises(ValueError, match="PIL does not open either"):
            decode_tiff(data)
        return
    assert_decodes_as_pil(data)


@pytest.mark.parametrize("bits", [1, 8])
def test_fill_order_2(bits):
    assert_decodes_as_pil(encode_tiff(noise((6, 13), 15, high=1 << bits), bits=bits, photometric=1, fill_order=2))


def jpeg_chunk(block: np.ndarray) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(block).save(buf, "JPEG", quality=85, subsampling=2)
    return buf.getvalue()


@pytest.mark.parametrize("layout", ["tiles", "strips"])
def test_jpeg_chunks_without_tables(layout):
    """JPEG tiles and strips each carrying its own tables (no
    JPEGTables), YCbCr 4:2:0."""
    y, x = np.mgrid[0:40, 0:56]
    pixels = np.stack([x * 4, y * 5, (x + y) * 2], -1).astype(np.uint8)
    kw = dict(tile=(32, 32)) if layout == "tiles" else dict(rows_per_strip=16)
    assert_decodes_as_pil(encode_tiff(pixels, photometric=6, compression=7, jpeg_chunks=jpeg_chunk,
                                      subsampling=(2, 2), **kw))


def test_larger_image():
    """A chart-sized file: 300x400 LZW with the predictor, in strips."""
    pixels = np.kron(noise((30, 40, 3), 16), np.ones((10, 10, 1), np.uint8))
    assert_decodes_as_pil(pil_tiff(Image.fromarray(pixels), compression="tiff_lzw", tiffinfo={317: 2}))


# -- refusals ------------------------------------------------------------------


@pytest.mark.parametrize("case", ["float", "signed_16", "ccitt_group4", "zstd", "ycbcr_raw", "float_predictor"])
def test_refused_variants_name_item_16(case):
    if case == "float":
        data = pil_tiff(Image.fromarray(noise((5, 6), 17).astype(np.float32)))
    elif case == "signed_16":
        data = encode_tiff(noise((5, 6), 18, high=3000, dtype=np.uint16), bits=16, photometric=1, sample_format=2)
    elif case == "ccitt_group4":
        data = pil_tiff(Image.fromarray(noise((16, 24), 19, high=2) * 255).convert("1"), compression="group4")
    elif case == "zstd":
        data = encode_tiff(noise((5, 6, 3), 20)).replace(struct.pack("<HHII", 259, 3, 1, 1),
                                                         struct.pack("<HHII", 259, 3, 1, 50000))
    elif case == "ycbcr_raw":
        data = encode_tiff(noise((4, 4, 3), 21), photometric=6)
    else:
        data = encode_tiff(noise((4, 4, 3), 22), compression=8, predictor=3)
    with pytest.raises(ValueError, match="item 16"):
        decode_tiff(data)


@pytest.mark.parametrize("cut", [0.02, 0.2, 0.5, 0.9])
def test_truncated_files_raise(cut):
    data = encode_tiff(noise((30, 30, 3), 23), compression=5, rows_per_strip=10)
    # the IFD sits at the end: cut the strips, then point past the end
    short = data[:8] + data[8 : int(len(data) * cut)]
    short = short[:4] + struct.pack("<I", len(data) - 40) + short[8:] if len(short) > 8 else short
    with pytest.raises((OSError, ValueError, SyntaxError)):
        pil_rgb(short)
    with pytest.raises(ValueError, match="truncated TIFF|not a TIFF"):
        decode_tiff(short)


def test_corrupt_files_raise_saying_what_is_wrong():
    data = bytearray(encode_tiff(noise((8, 8, 3), 24), compression=8))
    data[8:12] = b"\xff\xff\xff\xff"  # the strip's deflate header
    with pytest.raises(ValueError, match="corrupt TIFF: chunk 0 does not inflate"):
        decode_tiff(bytes(data))
    with pytest.raises(ValueError, match="not a TIFF"):
        decode_tiff(b"II\x2c\x00" + bytes(20))
