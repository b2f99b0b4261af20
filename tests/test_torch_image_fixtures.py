"""The committed chart images under
``pipelinerl_tpu_torch/fixtures/images/`` (``chip_smoke.py``'s phase 26:
the 600x800 group's lossy WebP with alpha, and one file of each other
format for the image gates) and raw images (``.npy``: a 2-D array of each
dtype PIL reads as I;16, I or F, and a PIL image's samples in each mode of
``RAW_MODES``) are what ``build_fixture_images`` writes,
``digests.json`` holds the SHA-256 of PIL's RGB of each, and the port's
``decode_image`` (``array_to_rgb`` for the raw ones) gives that RGB.
``PYTHONPATH=. python tests/test_torch_image_fixtures.py`` writes them
again.
"""

import hashlib
import io
import json
from pathlib import Path

import numpy as np
from PIL import Image

import chip_smoke
from chip_smoke import RAW_PALETTE, raw_gate_image
from pipelinerl_tpu_torch.inference import image_pipeline as ip
from pipelinerl_tpu_torch.inference.processor import array_to_rgb
from tests.test_torch_bmp import encode_bmp
from tests.test_torch_ico import dib_entry, encode_icon
from tests.test_torch_jpeg import chart_image
from tests.test_torch_qoi_pcx_sgi import encode_sgi
from tests.test_torch_xbm_xpm import encode_xpm

FIXTURES = Path(__file__).resolve().parents[1] / "pipelinerl_tpu_torch" / "fixtures" / "images"
# the raw gates: a 2-D array of each dtype PIL reads as I;16, I or F (mode
# None), and a PIL image's samples in each mode
RAW_DTYPES = ("int8", "uint16", "int16", "int32", "uint32", "float32", "float64")
RAW_MODES = ("CMYK", "YCbCr", "HSV", "I;16", "I", "F", "PA", "RGBX", "RGBa")
RAW_GATES = {**{f"raw_96x128_{d}.npy": None for d in RAW_DTYPES},
             **{f"raw_96x128_{m.replace(';', '')}.npy": m for m in RAW_MODES}}
# phase 26's 600x800 group sends this one as its data URL
ROLLOUT_WEBP = "chart_600x800_lossy_alpha.webp"


def clean_chart(h: int, w: int, seed: int) -> np.ndarray:
    """A rendered chart's pixels, without the noise of a photographed one
    (what lossless formats carry): a shaded background, grid lines, axes,
    six bars shaded top to bottom, and rows of label glyphs."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([248 - y * 20 // h, 248 - y * 14 // h, 250 - x * 10 // w], -1).astype(np.int64)
    for gy in range(h // 10, h, h // 8):
        img[gy : gy + 1, w // 12 :] = 214
    img[: h - h // 12, w // 12 : w // 12 + 2] = 40
    img[h - h // 12 : h - h // 12 + 2, w // 12 :] = 40
    slot = (w - w // 8) // 6
    for i, colour in enumerate(rng.integers(30, 220, (6, 3))):
        top = int(rng.integers(h // 6, h - h // 5))
        x0 = w // 10 + i * slot
        shade = np.linspace(1.0, 0.75, h - h // 12 - top)[:, None, None]
        img[top : h - h // 12, x0 : x0 + slot * 2 // 3] = (colour * shade).astype(np.int64)
        glyphs = rng.integers(0, 2, (5, 3 * 4)).astype(bool)  # a four-glyph label under the bar
        ly, lx = h - h // 12 + 8, x0 + 4
        img[ly : ly + 5, lx : lx + 12][glyphs] = 60
    return img.astype(np.uint8)


def _save(image: Image.Image, fmt: str, **kw) -> bytes:
    buf = io.BytesIO()
    image.save(buf, fmt, **kw)
    return buf.getvalue()


def build_fixture_images() -> dict[str, bytes]:
    """The chart files: a lossy WebP with an alpha channel (a transparent
    margin around the plot) at phase 26's 600x800, and at 480x640 a GIF,
    an RLE8 BMP, an LZW TIFF with the horizontal predictor, a JPEG-in-TIFF
    and a lossless WebP; then ``build_raster_images`` and
    ``build_raw_images``."""
    rgb = chart_image(600, 800, seed=600)
    alpha = np.full((600, 800), 255, np.uint8)
    alpha[:24], alpha[-24:], alpha[:, :32], alpha[:, -32:] = 0, 0, 0, 0
    alpha[24:48, 32:-32] = np.linspace(0, 255, 24, dtype=np.uint8)[:, None]
    rgba = Image.fromarray(np.concatenate([rgb, alpha[..., None]], axis=-1), "RGBA")
    clean = Image.fromarray(clean_chart(480, 640, seed=480))
    quantized = clean.quantize(64)
    indices = np.asarray(quantized)
    table = np.asarray(quantized.getpalette(), np.uint8).reshape(-1, 3)
    return {
        ROLLOUT_WEBP: _save(rgba, "WEBP", quality=80),
        "chart_480x640.gif": _save(quantized, "GIF"),
        "chart_480x640_rle8.bmp": encode_bmp(indices, 8, compression=1, table=table),
        "chart_480x640_lzw_predictor.tif": _save(clean, "TIFF", compression="tiff_lzw", tiffinfo={317: 2}),
        "chart_480x640_jpeg.tif": _save(Image.fromarray(chart_image(480, 640, seed=481)), "TIFF", compression="jpeg",
                                        quality=90),
        "chart_480x640_lossless.webp": _save(clean, "WEBP", lossless=True),
        **build_raster_images(),
        **build_raw_images(),
    }


def build_raster_images() -> dict[str, bytes]:
    """Phase 26's gates of the formats ported after WebP
    (``chip_smoke.RASTER_GATES``):
    an ICO of a 64x64 and a 256x256 DIB entry (8-bit, with AND masks), a
    24-bit CUR, and at 240x320 a binary PPM, a top-down RLE TGA, a QOI, an
    8-bit palette PCX, an RLE SGI, an XBM and an XPM of 48 colours."""
    clean = clean_chart(240, 320, seed=240)
    square = Image.fromarray(clean_chart(256, 256, seed=256)).quantize(64)
    rgb = Image.fromarray(clean)
    quantized = rgb.quantize(48)
    table = np.asarray(quantized.getpalette(), np.uint8).reshape(-1, 3)[:48]
    cursor = clean_chart(192, 256, seed=96)[::2, ::2]
    files = {
        "chart_256x256.ico": _save(square, "ICO", sizes=[(64, 64), (256, 256)], bitmap_format="bmp"),
        "chart_96x128.cur": encode_icon([(128, 96, 0, 24, dib_entry(cursor, 24))], kind=2),
        "chart_240x320.ppm": _save(rgb, "PPM"),
        "chart_240x320_rle.tga": _save(rgb, "TGA", compression="tga_rle", orientation=1),
        "chart_240x320.qoi": _save(rgb, "QOI"),
        "chart_240x320.pcx": _save(rgb.quantize(64), "PCX"),
        "chart_240x320_rle.sgi": encode_sgi(np.moveaxis(clean, -1, 0).astype(np.int64), 1, True),
        "chart_240x320.xbm": _save(rgb.convert("L").point(lambda v: 255 if v > 200 else 0).convert("1"), "XBM"),
        "chart_240x320.xpm": encode_xpm(np.asarray(quantized), ["#%02x%02x%02x" % tuple(c) for c in table], 1),
    }
    return files


def raw_image(mode: str | None, name: str, grey: np.ndarray, rgb: np.ndarray):
    """The raw image of one of ``RAW_GATES``, from a chart's grey and RGB
    samples, its values past [0, 255] both ways where its type allows: an
    array (``mode`` None), or a PIL image in ``mode``."""
    g = grey.astype(np.int64)
    if mode is None:
        dtype = name[len("raw_96x128_") : -len(".npy")]
        values = {"int8": g - 128, "uint16": g * 3, "int16": (g - 60) * 2, "int32": (g - 100) * 40_000,
                  "uint32": g + np.where(g < 100, 2**31, 0)}.get(dtype)
        if values is None:
            f = g * 1.3 - 40.37
            f.flat[::97] = np.nan
            return f.astype(dtype)
        return values.astype(dtype)
    if mode in ("I;16", "I", "F"):
        values = {"I;16": g * 300, "I": g * 3 - 200, "F": g * 1.7 - 50.25}[mode]
        image = Image.new(mode, grey.shape[::-1])
        image.frombytes(values.astype({"I;16": "<u2", "I": "<i4", "F": "<f4"}[mode]).tobytes())
        return image
    if mode == "PA":
        quantized = Image.fromarray(rgb).quantize(40)
        image = Image.frombytes("PA", grey.shape[::-1], np.dstack([np.asarray(quantized), grey]).tobytes())
        image.putpalette(quantized.getpalette()[:120])
        return image
    alpha = np.linspace(60, 255, rgb.shape[1]).astype(np.uint8)[None, :].repeat(rgb.shape[0], 0)
    samples = {"CMYK": np.dstack([255 - rgb, np.minimum(255 - rgb.max(-1), 90).astype(np.uint8)]),
               "YCbCr": rgb, "HSV": rgb, "RGBX": np.dstack([rgb, alpha]),
               "RGBa": np.dstack([(rgb.astype(np.int64) * alpha[..., None] // 255).astype(np.uint8), alpha])}[mode]
    return Image.frombytes(mode, grey.shape[::-1], np.ascontiguousarray(samples).tobytes())


def build_raw_images() -> dict[str, bytes]:
    """``RAW_GATES`` as ``.npy`` files (each PIL image's samples as its
    ``__array_interface__`` gives them) and PA's palette."""
    rgb = clean_chart(192, 256, seed=97)[::2, ::2]
    grey = np.asarray(Image.fromarray(rgb).convert("L"))
    files = {}
    for name, mode in RAW_GATES.items():
        image = raw_image(mode, name, grey, rgb)
        buf = io.BytesIO()
        np.save(buf, np.asarray(image), allow_pickle=False)
        files[name] = buf.getvalue()
        if mode == "PA":
            buf = io.BytesIO()
            np.save(buf, np.asarray(image.getpalette(), np.uint8), allow_pickle=False)
            files[RAW_PALETTE] = buf.getvalue()
    return files


def pil_rgb(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def raw_pil_rgb(name: str) -> np.ndarray:
    """PIL's RGB of a raw gate: ``Image.fromarray`` of the array, or the
    PIL image the file's samples came from."""
    rgb = clean_chart(192, 256, seed=97)[::2, ::2]
    grey = np.asarray(Image.fromarray(rgb).convert("L"))
    image = raw_image(RAW_GATES[name], name, grey, rgb)
    return np.asarray((Image.fromarray(image) if isinstance(image, np.ndarray) else image).convert("RGB"))


def digests(files: dict[str, bytes]) -> dict[str, str]:
    return {name: hashlib.sha256((raw_pil_rgb(name) if name in RAW_GATES else pil_rgb(data)).tobytes()).hexdigest()
            for name, data in files.items() if name != RAW_PALETTE}


def test_fixture_images_are_what_build_fixture_images_writes():
    built = build_fixture_images()
    committed = json.loads((FIXTURES / "digests.json").read_text())
    assert committed == digests(built)
    assert sorted(p.name for p in FIXTURES.iterdir() if p.name != "digests.json") == sorted(built)
    for name, data in built.items():
        assert (FIXTURES / name).read_bytes() == data, name
        if name == RAW_PALETTE:
            continue
        if name in RAW_GATES:
            got = array_to_rgb(raw_gate_image(FIXTURES, name))
            np.testing.assert_array_equal(got, raw_pil_rgb(name))
        else:
            got = ip.decode_image(data)
            np.testing.assert_array_equal(got, pil_rgb(data))
        assert hashlib.sha256(got.tobytes()).hexdigest() == committed[name]
    new = {**build_raster_images(), **build_raw_images()}
    assert sum(len(d) for n, d in built.items() if n not in new) < 1_500_000
    assert sum(len(d) for d in new.values()) < 2_000_000
    # the smoke reads its gates from digests.json
    assert chip_smoke.RASTER_GATES == tuple(build_raster_images())
    assert chip_smoke.RAW_GATES == RAW_GATES


def test_raw_gates_cover_every_dtype_and_mode():
    """Each raw gate is what its name says, and its values reach past
    [0, 255] where its type allows."""
    for name, mode in RAW_GATES.items():
        image = raw_gate_image(FIXTURES, name)
        array = np.asarray(image)
        if mode is None:
            assert array.dtype == np.dtype(name[len("raw_96x128_") : -len(".npy")]) and array.shape == (96, 128)
            assert Image.fromarray(array).mode in ("I", "I;16", "F")
        else:
            assert image.mode == mode and array.shape[:2] == (96, 128)
        if array.dtype != np.uint8:
            assert np.nanmin(array.astype(np.float64)) < 0 or np.nanmax(array.astype(np.float64)) > 255, name


def test_rollout_webp_is_lossy_with_alpha():
    data = (FIXTURES / ROLLOUT_WEBP).read_bytes()
    assert data[12:16] == b"VP8X" and b"ALPH" in data and b"VP8 " in data
    assert ip.decode_image(data).shape == (600, 800, 3)


if __name__ == "__main__":
    FIXTURES.mkdir(parents=True, exist_ok=True)
    files = build_fixture_images()
    for name, data in files.items():
        (FIXTURES / name).write_bytes(data)
    (FIXTURES / "digests.json").write_text(json.dumps(digests(files), indent=1) + "\n")
    print({name: len(data) for name, data in files.items()})
