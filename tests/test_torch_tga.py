"""The port's TGA decoder (``inference/image_tga.decode_tga``) against
PIL's ``Image.open(...).convert("RGB")``, bit for bit: files PIL writes (1,
L, LA, P, RGB and RGBA, raw and RLE, each origin), and files ``encode_tga``
below writes for the rest of what PIL's ``TgaImagePlugin`` reads: 16-bit
true colour, colour maps of 16- and 24-bit entries that start past index
0 or run short, an ID field, each origin flag, raw packets that run
across rows. PIL's own detection holds too: TGA has no magic, and
``Image.open`` reaches it after every plugin before it declines, so a
header TGA does not accept (a bad colour-map type, depth, image type or
size) raises in both packages, naming item 16 in the port; a run packet
that crosses a row's end, a colour map of 32-bit entries or past index
255, a type Pillow has no unpacker for, and a 10-byte ID field (PCX's
magic, whose plugin fails the file before TGA's is tried) fail in both.
"""

import io
import struct

import numpy as np
import pytest
from PIL import Image

from pipelinerl_tpu_torch.inference import image_pipeline as ip
from pipelinerl_tpu_torch.inference.image_tga import decode_tga


def pil_rgb(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def assert_decodes_as_pil(data: bytes) -> None:
    want = pil_rgb(data)
    assert Image.open(io.BytesIO(data)).format == "TGA"
    np.testing.assert_array_equal(decode_tga(data), want)
    np.testing.assert_array_equal(ip.decode_image(data), want)


def rle_packets(body: bytes, unit: int, row_bytes: int, cross: bool) -> bytes:
    """TGA RLE of ``body``: runs of equal pixels within a row, raw packets
    of up to 128 pixels that run across rows where ``cross``."""
    px = [body[i : i + unit] for i in range(0, len(body), unit)]
    per_row = row_bytes // unit
    out, i = bytearray(), 0
    while i < len(px):
        row_end = (i // per_row + 1) * per_row
        run = 1
        while i + run < row_end and run < 128 and px[i + run] == px[i]:
            run += 1
        if run >= 2:
            out += bytes([0x80 | (run - 1)]) + px[i]
            i += run
            continue
        end = min(len(px), i + 128) if cross else min(row_end, i + 128)
        j = i + 1
        while j < end and not (j + 1 < end and px[j + 1] == px[j] and (j + 1) // per_row == j // per_row):
            j += 1
        out += bytes([j - i - 1]) + b"".join(px[i:j])
        i = j
    return bytes(out)


def encode_tga(rows: np.ndarray, image_type: int, depth: int, flags: int = 0, cmap: bytes = b"", cmap_start: int = 0,
               cmap_depth: int = 0, ident: bytes = b"", cross: bool = False) -> bytes:
    """A TGA file of ``rows`` ([h, row_bytes] uint8, in file order): the
    header, an ID field, a colour map of ``cmap`` entries from
    ``cmap_start``, then the rows raw or (image types 9-11) in RLE."""
    h, row_bytes = rows.shape
    w = row_bytes * 8 // depth
    n_cmap = len(cmap) // max(1, (cmap_depth + 7) // 8)
    head = struct.pack("<BBBHHBHHHHBB", len(ident), 1 if cmap else 0, image_type, cmap_start, n_cmap, cmap_depth,
                       0, 0, w, h, depth, flags)
    body = rows.tobytes()
    if image_type & 8:
        body = rle_packets(body, (depth + 7) // 8, row_bytes, cross)
    return head + ident + cmap + body


def noise(shape, seed, high=256):
    return np.random.default_rng(seed).integers(0, high, shape, dtype=np.uint8)


def blocky(h, w, channels, seed):
    """Pixels in runs (so RLE has runs to find), with noise between."""
    base = noise((h, (w + 3) // 4, channels), seed).repeat(4, axis=1)[:, :w]
    mask = np.random.default_rng(seed + 1).random((h, w)) < 0.3
    base[mask] = noise((int(mask.sum()), channels), seed + 2)
    return base


@pytest.mark.parametrize("mode", ["1", "L", "LA", "P", "RGB", "RGBA"])
@pytest.mark.parametrize("compression", [None, "tga_rle"])
@pytest.mark.parametrize("orientation", [1, -1])
def test_files_pil_writes(mode, compression, orientation):
    if mode == "1" and compression:  # PIL writes it, then cannot read it: both fail below
        return test_refusals_fail_in_both("rle_bilevel")
    rgba = blocky(17, 29, 4, 1)
    image = Image.fromarray(rgba, "RGBA")
    image = image.quantize(40) if mode == "P" else image.convert(mode)
    buf = io.BytesIO()
    image.save(buf, "TGA", compression=compression, orientation=orientation)
    assert_decodes_as_pil(buf.getvalue())


@pytest.mark.parametrize("flags", [0x00, 0x10, 0x20, 0x30, 0x28])
@pytest.mark.parametrize("image_type", [2, 10])
def test_16_bit_true_colour_and_origins(flags, image_type):
    rows = blocky(9, 23, 2, 3).reshape(9, 46)
    assert_decodes_as_pil(encode_tga(rows, image_type, 16, flags=flags, ident=b"an id"))


@pytest.mark.parametrize("cmap_depth", [16, 24])
@pytest.mark.parametrize("start, entries", [(0, 256), (3, 40), (100, 156), (0, 12)])
@pytest.mark.parametrize("image_type", [1, 9])
def test_colour_maps(cmap_depth, start, entries, image_type):
    """Indices into a map that starts at ``start`` and holds ``entries``
    (indices below the start, and past 256 or the end, read black)."""
    size = (cmap_depth + 7) // 8
    cmap = noise(entries * size, cmap_depth + start).tobytes()
    rows = blocky(11, 31, 1, start + entries)[..., 0]
    assert_decodes_as_pil(encode_tga(rows, image_type, 8, flags=0x20, cmap=cmap, cmap_start=start,
                                     cmap_depth=cmap_depth))


@pytest.mark.parametrize("depth, image_type", [(24, 10), (32, 10), (8, 11), (16, 11), (16, 10)])
def test_raw_packets_across_rows(depth, image_type):
    unit = depth // 8
    rows = noise((7, 13 * unit), depth)
    assert_decodes_as_pil(encode_tga(rows, image_type, depth, cross=True))


@pytest.mark.parametrize("case", ["cmap_type_2", "depth_12", "image_type_5", "zero_width", "short_header",
                                  "bad_cmap_depth", "run_across_rows", "truncated_raw", "truncated_rle",
                                  "rle_bilevel", "cmap_32", "cmap_past_255", "true_colour_8", "no_cmap",
                                  "id_of_10_bytes"])
def test_refusals_fail_in_both(case):
    """Headers Pillow's TGA plugin declines reach no plugin at all, so
    both raise, the port naming item 16; broken data fails in both."""
    good = encode_tga(noise((4, 15), 4), 2, 24)
    head = bytearray(good[:18])
    if case == "cmap_type_2":
        head[1] = 2
    elif case == "depth_12":
        head[16] = 12
    elif case == "image_type_5":
        head[2] = 5
    elif case == "zero_width":
        head[12:14] = b"\0\0"
    elif case == "bad_cmap_depth":
        head[1], head[2], head[5:8], head[16] = 1, 1, b"\x04\x00\x08", 8
    data = bytes(head) + good[18:]
    if case == "short_header":
        data = good[:17]
    elif case == "run_across_rows":
        data = bytes(head[:2]) + b"\x0a" + bytes(head[3:]) + bytes([0x80 | 5]) + b"abc" + bytes([0x80 | 3]) + b"abc"
        data = data[:12] + struct.pack("<HH", 5, 2) + data[16:]
    elif case == "truncated_raw":
        data = good[:-4]
    elif case == "truncated_rle":
        data = encode_tga(blocky(4, 5, 3, 9).reshape(4, 15), 10, 24)[:-3]
    elif case in ("cmap_32", "cmap_past_255"):
        depth, start = (32, 0) if case == "cmap_32" else (24, 200)
        data = encode_tga(noise((3, 7), 6), 1, 8, cmap=noise(100 * depth // 8, 7).tobytes(), cmap_start=start,
                          cmap_depth=depth)
    elif case == "true_colour_8":  # Pillow's header check passes, and it has no unpacker
        data = encode_tga(noise((5, 9), 1), 2, 8)
    elif case == "no_cmap":  # colour-mapped without a map: mode L, which the P unpacker does not fill
        data = encode_tga(noise((5, 9), 1), 1, 8)
    elif case == "id_of_10_bytes":  # its first bytes are PCX's magic: PCX's plugin fails it before TGA's runs
        data = encode_tga(noise((4, 15), 4), 2, 24, ident=b"0123456789")
    elif case == "rle_bilevel":
        buf = io.BytesIO()
        Image.fromarray(noise((8, 16), 5) > 127).save(buf, "TGA", compression="tga_rle")
        data = buf.getvalue()
    with pytest.raises(Exception):
        pil_rgb(data)
    with pytest.raises(ValueError, match="item 16" if case in ("cmap_type_2", "depth_12", "image_type_5",
                                                                "zero_width", "short_header", "bad_cmap_depth")
                       else None):
        ip.decode_image(data)
