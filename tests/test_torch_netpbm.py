"""The port's Netpbm decoder (``inference/image_netpbm.decode_netpbm``)
against PIL's ``Image.open(...).convert("RGB")``, bit for bit: files PIL
writes (P4, P5 at 8 and 16 bits, P6, the grey PFM), and files
``encode_netpbm`` below writes for the rest of what PIL's
``PpmImagePlugin`` reads: the plain P1, P2 and P3, every ``maxval`` kind
(1, 15, 255, 256, 1000, 65535), comments in the header (inside a token
too) and in plain data, the PFM in both byte orders, Pillow's own CMYK,
RGBA and P extensions. A colour PFM (``PF``) and PAM (``P7``) raise in
both; truncated and corrupt files raise in both.
"""

import io

import numpy as np
import pytest
from PIL import Image

from pipelinerl_tpu_torch.inference import image_pipeline as ip
from pipelinerl_tpu_torch.inference.image_netpbm import decode_netpbm


def pil_rgb(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def assert_decodes_as_pil(data: bytes) -> None:
    want = pil_rgb(data)
    assert Image.open(io.BytesIO(data)).format == "PPM"
    np.testing.assert_array_equal(decode_netpbm(data), want)
    np.testing.assert_array_equal(ip.decode_image(data), want)


def both_fail(data: bytes) -> None:
    with pytest.raises(Exception):
        pil_rgb(data)
    with pytest.raises(ValueError):
        ip.decode_image(data)


def encode_netpbm(samples: np.ndarray, magic: str, maxval: int = 255, header: bytes | None = None,
                  comment: bytes = b"") -> bytes:
    """A Netpbm file of ``samples`` ([h, w] for P1/P2/P4/P5, [h, w, 3] for
    P3/P6): plain ones as decimal text, twelve samples a line with
    ``comment`` after the first line; raw ones in one byte a sample up to
    ``maxval`` 255 and two big-endian bytes above."""
    h, w = samples.shape[:2]
    head = header if header is not None else b"%s\n%d %d\n" % (magic.encode(), w, h) + (
        b"" if magic in ("P1", "P4") else b"%d\n" % maxval)
    flat = samples.reshape(-1)
    if magic in ("P1", "P2", "P3"):
        lines = [b" ".join(b"%d" % v for v in flat[i : i + 12]) for i in range(0, len(flat), 12)]
        if comment and lines:
            lines[0] += comment
        return head + b"\n".join(lines) + b"\n"
    if magic == "P4":
        return head + np.packbits(samples.astype(bool), axis=1).tobytes()
    return head + flat.astype(np.uint8 if maxval < 256 else ">u2").tobytes()


def noise(shape, high, seed):
    return np.random.default_rng(seed).integers(0, high + 1, shape)


@pytest.mark.parametrize("mode", ["1", "L", "I;16", "RGB", "F"])
def test_files_pil_writes(mode):
    rng = np.random.default_rng(3)
    image = {"1": Image.fromarray(rng.random((21, 35)) > 0.5), "L": Image.fromarray(noise((21, 35), 255, 1).astype(np.uint8)),
             "I;16": Image.fromarray(noise((21, 35), 65535, 2).astype(np.uint16)),
             "RGB": Image.fromarray(noise((21, 35, 3), 255, 3).astype(np.uint8)),
             "F": Image.fromarray((rng.standard_normal((21, 35)) * 200 + 100).astype(np.float32))}[mode]
    buf = io.BytesIO()
    image.save(buf, "PPM")
    assert_decodes_as_pil(buf.getvalue())


@pytest.mark.parametrize("magic, maxval", [("P1", 1), ("P4", 1)] + [(m, v) for m in ("P2", "P3", "P5", "P6")
                                                                   for v in (1, 15, 255, 256, 1000, 65535)])
def test_every_magic_and_maxval(magic, maxval):
    shape = (13, 19, 3) if magic in ("P3", "P6") else (13, 19)
    assert_decodes_as_pil(encode_netpbm(noise(shape, maxval, maxval), magic, maxval))


@pytest.mark.parametrize("header", [
    b"P6\n# a comment\n19 13\n255\n", b"P6 19 13 255\n", b"P6\t19\r13\x0b255\x0c", b"P6\n1#split\n9 13\n255\n",
    b"P6\n#c\r19 13 # trailing\n255 ", b"P6\n+19 13\n255\n", b"P6\n19 13\n0255\n"])
def test_header_tokens_as_pil_reads_them(header):
    """Comments end at CR or LF, a comment inside a token joins its two
    halves, any whitespace byte separates, one ends the header."""
    samples = noise((13, 19, 3), 255, 5)
    assert_decodes_as_pil(header + samples.astype(np.uint8).tobytes())


@pytest.mark.parametrize("magic", ["P1", "P2", "P3"])
def test_comments_in_plain_data(magic):
    shape = (9, 14, 3) if magic == "P3" else (9, 14)
    maxval = 1 if magic == "P1" else 200
    samples = noise(shape, maxval, 6)
    assert_decodes_as_pil(encode_netpbm(samples, magic, maxval, comment=b" # a comment\r"))
    # a comment with no space before it joins the first line's last sample
    # to the next line's first (one sample fewer: one more at the end)
    digits = noise(shape, 1 if magic == "P1" else 9, 7)
    assert_decodes_as_pil(encode_netpbm(digits, magic, maxval, comment=b"#x\n") + b" 1\n")


def test_plain_bitmap_without_separators():
    """P1 samples need no whitespace between them."""
    samples = noise((7, 10), 1, 8)
    data = b"P1\n10 7\n" + b"".join(b"".join(b"%d" % v for v in row) + b"\n" for row in samples)
    assert_decodes_as_pil(data)


@pytest.mark.parametrize("order", ["<", ">"])
def test_pfm_in_both_byte_orders(order):
    values = np.concatenate([np.random.default_rng(9).standard_normal(300) * 300,
                             [np.nan, np.inf, -np.inf, 0.5, 254.9, 255.0, -0.0]]).astype(np.float32)
    values = np.resize(values, 16 * 20).reshape(16, 20)
    data = b"Pf\n20 16\n%s\n" % (b"-1.0" if order == "<" else b"2.5") + values.astype(order + "f4").tobytes()
    assert_decodes_as_pil(data)


@pytest.mark.parametrize("magic, bands", [(b"P0CMYK", 4), (b"PyCMYK", 4), (b"PyRGBA", 4), (b"PyP", 1)])
@pytest.mark.parametrize("maxval", [255, 1000])
def test_pillow_extensions(magic, bands, maxval):
    samples = noise((6, 11, bands), maxval, bands + maxval)
    size = 1 if maxval < 256 else 2
    data = b"%s\n11 6\n%d\n" % (magic, maxval) + samples.astype(np.uint8 if size == 1 else ">u2").tobytes()
    assert_decodes_as_pil(data)


@pytest.mark.parametrize("case", ["PF", "P7", "maxval_0", "maxval_65536", "sample_over_maxval",
                                  "long_token", "truncated_raw", "truncated_plain", "bad_bit", "scale_0", "no_header"])
def test_refusals_and_faults_fail_in_both(case):
    samples = noise((5, 6, 3), 255, 10).astype(np.uint8)
    data = {"PF": b"PF\n6 5\n-1.0\n" + bytes(360), "P7": b"P7\nWIDTH 6\nHEIGHT 5\nDEPTH 3\nMAXVAL 255\nENDHDR\n"
            + samples.tobytes(),
            "maxval_0": b"P6\n6 5\n0\n" + samples.tobytes(), "maxval_65536": b"P6\n6 5\n65536\n" + bytes(180),
            "sample_over_maxval": b"P2\n2 1\n10\n3 11\n", "long_token": b"P6\n000000000006 5\n255\n" + samples.tobytes(),
            "truncated_raw": encode_netpbm(samples, "P6")[:-7], "truncated_plain": b"P2\n3 3\n9\n1 2 3 4\n",
            "bad_bit": b"P1\n2 2\n0 1 2 0\n", "scale_0": b"Pf\n2 2\n0.0\n" + bytes(16), "no_header": b"P6\n6"}[case]
    both_fail(data)
