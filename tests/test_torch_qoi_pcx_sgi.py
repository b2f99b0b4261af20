"""The port's QOI, PCX and SGI decoders (``inference/image_qoi``,
``image_pcx``, ``image_sgi``) against PIL's ``Image.open(...)
.convert("RGB")``, bit for bit.

- QOI: files PIL writes (RGB, RGBA), and streams of random ops that
  ``qoi_ops`` below writes: every op, indices of slots never written,
  runs past the image's end, channels bytes other than 3 and 4.
- PCX: files PIL writes (1, L, P, RGB at odd and even widths), and files
  ``encode_pcx`` below writes: 2- and 4-plane 1-bit palettes, grey with a
  grey-ramp palette and with none, header strides that are and are not
  the width's, odd widths.
- SGI: files PIL writes (verbatim L, RGB, RGBA), and files ``encode_sgi``
  below writes: 16-bit samples, RLE at 8 and 16 bits, dimension 1.

Runs past a row's end, truncated files and layouts PIL does not open fail
in both packages.
"""

import io
import struct

import numpy as np
import pytest
from PIL import Image

from pipelinerl_tpu_torch.inference import image_pipeline as ip
from pipelinerl_tpu_torch.inference.image_pcx import decode_pcx
from pipelinerl_tpu_torch.inference.image_qoi import decode_qoi
from pipelinerl_tpu_torch.inference.image_sgi import decode_sgi

DECODERS = {"QOI": decode_qoi, "PCX": decode_pcx, "SGI": decode_sgi}


def pil_rgb(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def assert_decodes_as_pil(data: bytes, kind: str) -> None:
    want = pil_rgb(data)
    assert Image.open(io.BytesIO(data)).format == kind
    np.testing.assert_array_equal(DECODERS[kind](data), want)
    np.testing.assert_array_equal(ip.decode_image(data), want)


def both_fail(data: bytes) -> None:
    with pytest.raises(Exception):
        pil_rgb(data)
    with pytest.raises(ValueError):
        ip.decode_image(data)


def noise(shape, seed, high=256):
    return np.random.default_rng(seed).integers(0, high, shape, dtype=np.uint8)


def blocky(h, w, channels, seed):
    base = noise((h, (w + 4) // 5, channels), seed).repeat(5, axis=1)[:, :w]
    mask = np.random.default_rng(seed + 1).random((h, w)) < 0.25
    base[mask] = noise((int(mask.sum()), channels), seed + 2)
    return base


def save(image: Image.Image, fmt: str, **kw) -> bytes:
    buf = io.BytesIO()
    image.save(buf, fmt, **kw)
    return buf.getvalue()


# -- QOI ----------------------------------------------------------------------


def qoi_ops(n_pixels: int, seed: int, channels: int = 4) -> bytes:
    """A QOI file of random ops (RGB, RGBA, INDEX, DIFF, LUMA, RUN) whose
    pixels fill ``n_pixels`` (a last run may pass the end)."""
    rng = np.random.default_rng(seed)
    w = 16
    h = n_pixels // w
    body, count = bytearray(), 0
    while count < w * h:
        op = int(rng.integers(0, 6))
        if op == 0:
            body += bytes([0xFE]) + rng.integers(0, 256, 3, dtype=np.uint8).tobytes()
        elif op == 1:
            body += bytes([0xFF]) + rng.integers(0, 256, 4, dtype=np.uint8).tobytes()
        elif op == 2:
            body.append(int(rng.integers(0, 64)))
        elif op == 3:
            body.append(0x40 | int(rng.integers(0, 64)))
        elif op == 4:
            body += bytes([0x80 | int(rng.integers(0, 64)), int(rng.integers(0, 256))])
        else:
            run = int(rng.integers(1, 63))
            body.append(0xC0 | (run - 1))
            count += run
            continue
        count += 1
    return b"qoif" + struct.pack(">IIBB", w, h, channels, 0) + bytes(body) + b"\0" * 7 + b"\x01"


@pytest.mark.parametrize("mode", ["RGB", "RGBA"])
def test_qoi_files_pil_writes(mode):
    assert_decodes_as_pil(save(Image.fromarray(blocky(21, 33, 4, 1), "RGBA").convert(mode), "QOI"), "QOI")


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("channels", [3, 4, 7])
def test_qoi_random_op_streams(seed, channels):
    assert_decodes_as_pil(qoi_ops(16 * 40, seed, channels), "QOI")


def test_qoi_truncated_fails_in_both():
    both_fail(save(Image.fromarray(noise((9, 9, 3), 2)), "QOI")[:-40])


# -- PCX ----------------------------------------------------------------------


def pcx_rle(rows: np.ndarray) -> bytes:
    """PCX RLE of ``rows`` [h, row_bytes]: runs of up to 63 within a row,
    a byte of the top two bits set always as a run."""
    out = bytearray()
    for row in rows.tolist():
        x = 0
        while x < len(row):
            run = 1
            while x + run < len(row) and run < 63 and row[x + run] == row[x]:
                run += 1
            if run > 1 or row[x] >= 0xC0:
                out += bytes([0xC0 | run, row[x]])
            else:
                out.append(row[x])
            x += run
    return bytes(out)


def encode_pcx(rows: np.ndarray, w: int, bits: int, planes: int, stride: int, version: int = 5,
               palette16: bytes = bytes(48), tail: bytes = b"") -> bytes:
    """A PCX of ``rows`` [h, planes * stride] (each row's planes in turn),
    the header's stride ``stride``, then ``tail`` (a 769-byte palette)."""
    h = rows.shape[0]
    head = struct.pack("<BBBBHHHHHH", 10, version, 1, bits, 0, 0, w - 1, h - 1, 72, 72) + palette16
    head += bytes([0, planes]) + struct.pack("<HH", stride, 1) + bytes(58)
    return head + pcx_rle(rows) + tail


@pytest.mark.parametrize("mode", ["1", "L", "P", "RGB"])
@pytest.mark.parametrize("width", [30, 31, 64])
def test_pcx_files_pil_writes(mode, width):
    image = Image.fromarray(blocky(13, width, 3, width), "RGB")
    image = image.quantize(50) if mode == "P" else image.convert(mode)
    assert_decodes_as_pil(save(image, "PCX"), "PCX")


@pytest.mark.parametrize("planes", [2, 4])
@pytest.mark.parametrize("width", [8, 13, 24, 40])
@pytest.mark.parametrize("given", ["exact", "even"])
def test_pcx_bit_planes(planes, width, given):
    """Indices of 2 or 4 one-bit planes into the header's 16 colours."""
    stride = (width + 7) // 8
    header_stride = stride if given == "exact" else stride + stride % 2 + 2
    row_stride = stride if given == "exact" else stride + stride % 2
    rows = noise((9, planes * row_stride), width + planes)
    assert_decodes_as_pil(encode_pcx(rows, width, 1, planes, header_stride, palette16=noise(48, 1).tobytes()), "PCX")


@pytest.mark.parametrize("tail", ["grey_ramp", "none", "none_short", "palette"])
@pytest.mark.parametrize("width", [17, 20])
def test_pcx_grey_and_palette(tail, width):
    table = {"grey_ramp": np.repeat(np.arange(256, dtype=np.uint8), 3), "palette": noise(768, 3)}.get(tail)
    end = b"" if table is None else b"\x0c" + table.tobytes()
    stride = width + width % 2
    rows = noise((11, stride), width)
    data = encode_pcx(rows, width, 8, 1, width, tail=end)
    if tail == "none":
        data += bytes(800)  # Pillow reads 769 bytes back from the end (from 0 in a shorter file)
    assert_decodes_as_pil(data, "PCX")


@pytest.mark.parametrize("width", [1, 3, 5, 16, 33])
@pytest.mark.parametrize("given", ["exact", "other"])
def test_pcx_rgb_planes_at_odd_widths(width, given):
    """Three planes a row; a stride made even is moved together as
    Pillow's decoder moves it (narrow widths included)."""
    stride = width + (width % 2 if given == "other" else 0)
    rows = noise((7, 3 * stride), width + 40)
    assert_decodes_as_pil(encode_pcx(rows, width, 8, 3, width if given == "exact" else width + 7), "PCX")


@pytest.mark.parametrize("case", ["run_across_rows", "truncated", "bits_4", "version_2_grey"])
def test_pcx_faults_fail_in_both(case):
    rows = noise((4, 10), 5)
    if case == "run_across_rows":
        data = encode_pcx(rows, 10, 8, 1, 10, tail=bytes(800))
        data = data[:128] + bytes([0xC0 | 14, 7]) + data[128:]
    elif case == "truncated":
        data = save(Image.fromarray(noise((20, 20, 3), 1)), "PCX")[:-30]
    elif case == "bits_4":
        data = encode_pcx(rows, 20, 4, 1, 10) + bytes(800)
    else:
        data = encode_pcx(rows, 10, 8, 1, 10, version=2) + bytes(800)
    both_fail(data)


# -- SGI ----------------------------------------------------------------------


def sgi_rle_row(values: np.ndarray, bpc: int) -> bytes:
    """One channel's row of SGI RLE: runs of 2 or more, copies of the rest,
    at most 127 a packet, a zero count last."""
    out, x, n = [], 0, len(values)
    while x < n:
        run = 1
        while x + run < n and run < 127 and values[x + run] == values[x]:
            run += 1
        if run > 1:
            out += [run, int(values[x])]
            x += run
            continue
        end = x + 1
        while end < n and end - x < 127 and not (end + 1 < n and values[end + 1] == values[end]):
            end += 1
        out += [0x80 | (end - x), *values[x:end].tolist()]
        x = end
    out.append(0)
    return np.asarray(out, np.uint8 if bpc == 1 else ">u2").tobytes()


def encode_sgi(planes: np.ndarray, bpc: int, rle: bool, dimension: int = 3) -> bytes:
    """An SGI file of ``planes`` [z, h, w] (rows top-down; written
    bottom-up): verbatim planes, or RLE rows behind their offset and
    length tables."""
    z, h, w = planes.shape
    head = struct.pack(">HBBHHHH", 474, int(rle), bpc, dimension, w, h, z).ljust(512, b"\0")
    rows = planes[:, ::-1]
    if not rle:
        return head + rows.astype(np.uint8 if bpc == 1 else ">u2").tobytes()
    blobs = [sgi_rle_row(rows[c, y], bpc) for c in range(z) for y in range(h)]
    offset = 512 + 8 * z * h
    starts, lengths = [], []
    for blob in blobs:
        starts.append(offset)
        lengths.append(len(blob))
        offset += len(blob)
    return head + np.asarray(starts, ">u4").tobytes() + np.asarray(lengths, ">u4").tobytes() + b"".join(blobs)


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA"])
def test_sgi_files_pil_writes(mode):
    image = Image.fromarray(blocky(15, 22, 4, 2), "RGBA").convert(mode)
    assert_decodes_as_pil(save(image, "SGI"), "SGI")


@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("bpc", [1, 2])
@pytest.mark.parametrize("rle", [False, True])
def test_sgi_depths_and_rle(channels, bpc, rle):
    rng = np.random.default_rng(channels * 10 + bpc)
    planes = np.moveaxis(blocky(12, 29, channels, bpc), -1, 0).astype(np.int64)
    if bpc == 2:
        planes = planes * 256 + rng.integers(0, 256, planes.shape)
    dimension = 3 if channels > 1 else 2
    assert_decodes_as_pil(encode_sgi(planes, bpc, rle, dimension), "SGI")


def test_sgi_dimension_1():
    assert_decodes_as_pil(encode_sgi(noise((1, 1, 30), 4).astype(np.int64), 1, False, dimension=1), "SGI")


@pytest.mark.parametrize("case", ["truncated_verbatim", "truncated_rle", "row_past_width", "channels_2"])
def test_sgi_faults_fail_in_both(case):
    planes = noise((3, 6, 10), 1).astype(np.int64)
    if case == "truncated_verbatim":
        data = encode_sgi(planes, 1, False)[:-9]
    elif case == "truncated_rle":
        data = encode_sgi(planes, 1, True)[:-30]
    elif case == "row_past_width":
        data = bytearray(encode_sgi(planes, 1, True))
        start = struct.unpack_from(">I", data, 512)[0]
        data[start : start + 2] = bytes([0x7F, 9])
        data = bytes(data)
    else:
        data = encode_sgi(planes[:2], 1, False)
    both_fail(data)
