"""The committed chart images under
``pipelinerl_tpu_torch/fixtures/images/`` (``chip_smoke.py``'s phase 26:
the 600x800 group's lossy WebP with alpha, and one file of each other
new format for the image gates) are what ``build_fixture_images`` writes,
``digests.json`` holds the SHA-256 of PIL's RGB of each, and the port's
``decode_image`` gives that RGB. ``PYTHONPATH=. python
tests/test_torch_image_fixtures.py`` writes them again.
"""

import hashlib
import io
import json
from pathlib import Path

import numpy as np
from PIL import Image

from pipelinerl_tpu_torch.inference import image_pipeline as ip
from tests.test_torch_bmp import encode_bmp
from tests.test_torch_jpeg import chart_image

FIXTURES = Path(__file__).resolve().parents[1] / "pipelinerl_tpu_torch" / "fixtures" / "images"
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
    and a lossless WebP."""
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
    }


def pil_rgb(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def digests(files: dict[str, bytes]) -> dict[str, str]:
    return {name: hashlib.sha256(pil_rgb(data).tobytes()).hexdigest() for name, data in files.items()}


def test_fixture_images_are_what_build_fixture_images_writes():
    built = build_fixture_images()
    committed = json.loads((FIXTURES / "digests.json").read_text())
    assert committed == digests(built)
    assert sorted(p.name for p in FIXTURES.iterdir() if p.name != "digests.json") == sorted(built)
    for name, data in built.items():
        assert (FIXTURES / name).read_bytes() == data, name
        got = ip.decode_image(data)
        np.testing.assert_array_equal(got, pil_rgb(data))
        assert hashlib.sha256(got.tobytes()).hexdigest() == committed[name]
    assert sum(len(d) for d in built.values()) < 1_500_000


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
