"""The port's ICO and CUR decoders (``inference/image_ico``) against PIL's
``Image.open(...).convert("RGB")``, bit for bit: icons PIL writes (PNG
entries, and DIB entries with their AND masks, each of 1, L, P, RGB and
RGBA), and files ``encode_icon`` below writes for the rest: 32-bit DIB
entries, several entries of one size at different depths (Pillow loads
the largest, and of those the shallowest), a colour count without a bit
count, cursors whose largest entry is not the first. A mask that runs past
the file's end, a PNG in a cursor, and a directory with no entries (which
no plugin then reads) fail in both packages.
"""

import io
import struct

import numpy as np
import pytest
from PIL import Image

from pipelinerl_tpu_torch.inference import image_pipeline as ip
from pipelinerl_tpu_torch.inference.image_ico import decode_cur, decode_ico
from tests.test_torch_bmp import encode_bmp


def pil_rgb(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def assert_decodes_as_pil(data: bytes, kind: str) -> None:
    want = pil_rgb(data)
    assert Image.open(io.BytesIO(data)).format == kind
    np.testing.assert_array_equal((decode_ico if kind == "ICO" else decode_cur)(data), want)
    np.testing.assert_array_equal(ip.decode_image(data), want)


def noise(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def dib_entry(pixels: np.ndarray, bits: int, mask: bool = True, table: np.ndarray | None = None) -> bytes:
    """A DIB of ``pixels`` ([h, w] indices or [h, w, 3|4]) at ``bits``: the
    BMP writer's bytes without the file header, its height doubled, and an
    AND mask of 1-bit rows after the pixels."""
    bmp = encode_bmp(pixels, bits, table=table)
    dib = bytearray(bmp[14:])
    h, w = pixels.shape[:2]
    struct.pack_into("<i", dib, 8, 2 * h)
    if mask:
        stride = (w + 31) // 32 * 4
        dib += noise((h, stride), w + h).tobytes()
    return bytes(dib)


def encode_icon(entries: list[tuple[int, int, int, int, bytes]], kind: int = 1) -> bytes:
    """An ICO (``kind`` 1) or CUR (2) of ``entries``, each (width byte,
    height byte, colour count, bit count, the entry's bytes)."""
    head = struct.pack("<HHH", 0, kind, len(entries))
    offset = 6 + 16 * len(entries)
    directory, body = b"", b""
    for w, h, colors, bits, blob in entries:
        directory += struct.pack("<BBBBHHII", w, h, colors, 0, 1, bits, len(blob), offset + len(body))
        body += blob
    return head + directory + body


@pytest.mark.parametrize("mode", ["1", "L", "P", "RGB", "RGBA"])
@pytest.mark.parametrize("bitmap_format", ["png", "bmp"])
def test_icons_pil_writes(mode, bitmap_format):
    image = Image.fromarray(noise((40, 40, 4), 3), "RGBA")
    image = image.quantize(30) if mode == "P" else image.convert(mode)
    buf = io.BytesIO()
    image.save(buf, "ICO", sizes=[(16, 16), (24, 24), (40, 40)], bitmap_format=bitmap_format)
    assert_decodes_as_pil(buf.getvalue(), "ICO")


@pytest.mark.parametrize("bits", [1, 4, 8, 24, 32])
def test_dib_entries_of_each_depth(bits):
    if bits <= 8:
        pixels, table = noise((20, 27), bits) >> (8 - bits), noise((1 << bits, 3), bits + 1)
    else:
        pixels, table = noise((20, 27, bits // 8), bits), None
    blob = dib_entry(pixels, bits, mask=bits != 32, table=table)
    assert_decodes_as_pil(encode_icon([(27, 20, 0, bits, blob)]), "ICO")


def test_pillow_loads_the_largest_then_the_shallowest():
    """Two 24x24 entries (8 and 24 bits, the deeper first) beside a 16x16
    PNG: Pillow sorts by depth, then stably by area, and loads the first."""
    small = io.BytesIO()
    Image.fromarray(noise((16, 16, 3), 1)).save(small, "PNG")
    deep = dib_entry(noise((24, 24, 3), 2), 24)
    shallow = dib_entry(noise((24, 24), 3), 8, table=noise((256, 3), 4))
    data = encode_icon([(16, 16, 0, 32, small.getvalue()), (24, 24, 0, 24, deep), (24, 24, 0, 8, shallow)])
    assert_decodes_as_pil(data, "ICO")
    # a colour count without a bit count gives the depth: 16 colours sort before 24 bits
    data = encode_icon([(24, 24, 0, 24, deep), (24, 24, 16, 0, dib_entry(noise((24, 24), 5) % 16, 4,
                                                                           table=noise((16, 3), 6)))])
    assert_decodes_as_pil(data, "ICO")


@pytest.mark.parametrize("order", [(0, 1, 2), (2, 0, 1), (1, 2, 0)])
def test_cursors_take_their_largest_entry(order):
    sizes = [(8, 8), (32, 20), (16, 30)]
    blobs = [dib_entry(noise((h, w, 3), w), 24, mask=False) for w, h in sizes]
    entries = [(sizes[i][0], sizes[i][1], 0, 24, blobs[i]) for i in order]
    assert_decodes_as_pil(encode_icon(entries, kind=2), "CUR")


@pytest.mark.parametrize("case", ["mask_past_end", "alpha_past_end", "png_cursor", "no_entries", "bad_dib_header"])
def test_faults_fail_in_both(case):
    if case in ("mask_past_end", "alpha_past_end"):
        bits = 24 if case == "mask_past_end" else 32
        blob = dib_entry(noise((12, 12, bits // 8), 1), bits, mask=False)
        data = encode_icon([(12, 12, 0, bits, blob)])[:-20]
    elif case == "png_cursor":
        buf = io.BytesIO()
        Image.fromarray(noise((8, 8, 3), 1)).save(buf, "PNG")
        data = encode_icon([(8, 8, 0, 32, buf.getvalue())], kind=2)
    elif case == "no_entries":
        data = encode_icon([]) + bytes(40)
    else:
        data = encode_icon([(8, 8, 0, 24, b"\x07\0\0\0" + bytes(200))])
    with pytest.raises(Exception):
        pil_rgb(data)
    with pytest.raises(ValueError):
        ip.decode_image(data)
