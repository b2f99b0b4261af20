"""The port's ``array_to_rgb`` (``inference/processor.py``) against PIL's
``Image.fromarray(a).convert("RGB")`` and ``img.convert("RGB")``, bit for
bit: 2-D arrays of every type ``fromarray`` reads (bool, uint8, int8,
uint16, int16, int32, uint32, float32, float64, either byte order), uint8
arrays of 2, 3 and 4 channels, and PIL images in the modes 1, L, LA, P,
PA, RGB, RGBA, RGBX, RGBa, CMYK, YCbCr, HSV, I;16 (each byte order), I and
F, over every value of a sample where that is small (every pair for the
modes whose channels mix), and over values at the edges of clipping and
rounding for the rest. What PIL refuses (int64, 3-D float arrays, mode
La) the port refuses, naming ROADMAP item 16; so does LAB, which PIL
converts through LittleCMS.
"""

import numpy as np
import pytest
from PIL import Image

from pipelinerl_tpu_torch.inference.processor import array_to_rgb

EDGE_FLOATS = [np.nan, np.inf, -np.inf, -0.0, 0.0, 1e-30, 0.4999, 0.5, 0.9999999, 1.0, 1.5, 2.5, 127.5, 254.5,
               254.99998, 254.999999999, 255.0, 255.00001, 255.5, 256.0, -0.5, -1.0, -255.0, 1e30, -1e30, 3e38]


def assert_as_pil(source, want_image):
    want = np.asarray(want_image.convert("RGB"))
    got = array_to_rgb(source)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def every_value(dtype: str) -> np.ndarray:
    """A 2-D array of ``dtype``: every value of a 1- or 2-byte type, else
    random values with the edges of the type and of [0, 255] among them."""
    native = np.dtype(dtype).newbyteorder("=")
    if native.kind == "b":
        return np.array([[False, True] * 8] * 3)
    if native.kind in "iu" and native.itemsize <= 2:
        info = np.iinfo(native)
        return np.arange(info.min, info.max + 1, dtype=np.int64).astype(native).reshape(-1, 256).astype(dtype)
    rng = np.random.default_rng(native.itemsize)
    if native.kind in "iu":
        info = np.iinfo(native)
        edges = [info.min, info.min + 1, -256, -255, -1, 0, 1, 127, 128, 254, 255, 256, 65535, 2**31 - 1,
                 info.max - 1, info.max]
        values = np.concatenate([[e for e in edges if info.min <= e <= info.max],
                                 rng.integers(info.min, info.max, 4000, endpoint=True)])
    else:
        values = np.concatenate([EDGE_FLOATS, rng.standard_normal(4000) * 300 + 100, rng.random(1000) * 256])
        if native.itemsize == 8:  # doubles that round to a float32 at an edge
            values = np.concatenate([values, [254.99999999999, 255 - 2**-30, 2**-149 / 3, 3.5e38]])
    values = np.resize(values.astype(native), 64 * ((len(values) + 63) // 64))
    return values.reshape(-1, 64).astype(dtype)


@pytest.mark.parametrize("dtype", ["bool", "uint8", "int8", "uint16", ">u2", "int16", ">i2", "int32", ">i4",
                                   "uint32", ">u4", "float32", ">f4", "float64", ">f8"])
def test_2d_arrays_read_as_fromarray_reads_them(dtype):
    array = every_value(dtype)
    with np.errstate(over="ignore"):
        assert_as_pil(array, Image.fromarray(array))


@pytest.mark.parametrize("channels", [2, 3, 4])
def test_uint8_channels_read_as_fromarray_reads_them(channels):
    array = np.random.default_rng(channels).integers(0, 256, (33, 47, channels), dtype=np.uint8)
    assert_as_pil(array, Image.fromarray(array))


def pairs(channels: int, a: int, b: int, seed: int) -> np.ndarray:
    """[256, 256, channels] uint8: every pair of values of channels ``a``
    and ``b``, the others random."""
    out = np.random.default_rng(seed).integers(0, 256, (256, 256, channels), dtype=np.uint8)
    out[..., a] = np.arange(256, dtype=np.uint8)[:, None]
    out[..., b] = np.arange(256, dtype=np.uint8)[None, :]
    return out


@pytest.mark.parametrize("mode, channels, a, b", [("CMYK", 4, 0, 3), ("CMYK", 4, 2, 3), ("RGBa", 4, 1, 3),
                                                  ("YCbCr", 3, 1, 2), ("YCbCr", 3, 0, 2), ("HSV", 3, 0, 1),
                                                  ("HSV", 3, 0, 2), ("HSV", 3, 1, 2), ("RGBX", 4, 0, 3),
                                                  ("LA", 2, 0, 1), ("RGBA", 4, 2, 3)])
def test_modes_over_every_pair_of_values(mode, channels, a, b):
    """A PIL image of the mode, duck-typed through ``mode`` and
    ``__array_interface__``: every pair of the two channels' values."""
    image = Image.fromarray(pairs(channels, a, b, seed=channels * 10 + a + b), mode)
    assert_as_pil(image, image)


def test_hsv_over_random_triples():
    array = np.random.default_rng(7).integers(0, 256, (512, 512, 3), dtype=np.uint8)
    image = Image.fromarray(array, "HSV")
    assert_as_pil(image, image)


@pytest.mark.parametrize("mode, dtype", [("I;16", "<u2"), ("I;16L", "<u2"), ("I;16B", ">u2"), ("I", "<i4"),
                                         ("F", "<f4")])
def test_wide_modes(mode, dtype):
    values = every_value("uint16" if mode.startswith("I;16") else dtype)
    image = Image.new(mode, values.shape[::-1])
    image.frombytes(values.astype(dtype).tobytes())
    assert_as_pil(image, image)


@pytest.mark.parametrize("mode", ["P", "PA"])
@pytest.mark.parametrize("entries", [0, 5, 256])
def test_palette_modes(mode, entries):
    """Indices into ``getpalette()``: a full palette, a short one (entries
    past it black), none."""
    rng = np.random.default_rng(entries)
    array = rng.integers(0, 256, (40, 64) if mode == "P" else (40, 64, 2), dtype=np.uint8)
    image = Image.frombytes(mode, (64, 40), array.tobytes())
    if entries:
        image.putpalette(rng.integers(0, 256, 3 * entries).tolist())
    assert_as_pil(image, image)


def test_bilevel_image():
    image = Image.fromarray(np.random.default_rng(1).random((30, 41)) > 0.5)
    assert_as_pil(image, image)


@pytest.mark.parametrize("case", ["int64", "uint64", "float16", "float32_rgb", "int16_rgb", "complex", "La", "LAB"])
def test_what_pil_refuses_or_lab_raises_naming_item_16(case):
    if case in ("La", "LAB"):
        source = Image.fromarray(np.zeros((4, 5, 2 if case == "La" else 3), np.uint8), case)
    else:
        dtype, shape = {"int64": ("int64", (4, 5)), "uint64": ("uint64", (4, 5)), "float16": ("float16", (4, 5)),
                        "float32_rgb": ("float32", (4, 5, 3)), "int16_rgb": ("int16", (4, 5, 3)),
                        "complex": ("complex64", (4, 5))}[case]
        source = np.zeros(shape, dtype)
    if case == "LAB":
        source.convert("RGB")  # PIL converts LAB (through LittleCMS): the port does not yet
    else:
        with pytest.raises((TypeError, ValueError)):
            Image.fromarray(source).convert("RGB") if isinstance(source, np.ndarray) else source.convert("RGB")
    with pytest.raises(ValueError, match="item 16"):
        array_to_rgb(source)
