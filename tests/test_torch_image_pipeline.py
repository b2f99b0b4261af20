"""The port's image pipeline (``inference/image_pipeline.py``) against the
libraries the JAX package calls: PNG decode against PIL's
``Image.open(...).convert("RGB")`` bit for bit, on files PIL writes (its
adaptive row filters) and on files built here for what PIL does not write
(grey at 2, 4 and 16 bits, RGB and RGBA at 16 bits, grey+alpha at 16 bits,
palettes at 1-4 bits, every filter type forced, Adam7); truncated and
corrupt files raise; ``smart_resize`` against transformers'; the bicubic
resize against PIL's ``resize(BICUBIC)`` bit for bit on uint8, up and
down; the port's encoder read back by PIL; the image processor against
transformers' ``Qwen2VLImageProcessor`` bit for bit."""

import io
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from pipelinerl_tpu_torch.inference import image_pipeline as ip

ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def chunk(kind: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", len(payload)) + kind + payload + struct.pack(">I", zlib.crc32(kind + payload))


def pack_rows(samples: np.ndarray, depth: int) -> np.ndarray:
    """Rows of bytes [h, stride] of samples [h, w, ch] at ``depth`` bits."""
    h, w, ch = samples.shape
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(h, w * ch * 2)
    if depth == 8:
        return samples.astype(np.uint8).reshape(h, w * ch)
    flat = samples.reshape(h, w * ch).astype(np.uint8)
    per = 8 // depth
    pad = (-flat.shape[1]) % per
    flat = np.concatenate([flat, np.zeros((h, pad), np.uint8)], axis=1).reshape(h, -1, per)
    shifts = np.arange(8 - depth, -1, -depth)
    return (flat << shifts).sum(-1).astype(np.uint8)


def filter_rows(rows: np.ndarray, bpp: int, kinds: list[int]) -> bytes:
    """Each row filtered by its kind, written byte by byte as the PNG
    standard defines the filters."""
    h, stride = rows.shape
    out = bytearray()
    prev = np.zeros(stride, np.int64)
    for r in range(h):
        x = rows[r].astype(np.int64)
        out.append(kinds[r])
        for i in range(stride):
            a = x[i - bpp] if i >= bpp else 0
            b = prev[i]
            c = prev[i - bpp] if i >= bpp else 0
            if kinds[r] == 0:
                pred = 0
            elif kinds[r] == 1:
                pred = a
            elif kinds[r] == 2:
                pred = b
            elif kinds[r] == 3:
                pred = (a + b) // 2
            else:
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            out.append((int(x[i]) - int(pred)) & 0xFF)
        prev = x
    return bytes(out)


def build_png(samples: np.ndarray, color: int, depth: int, interlace: bool = False, palette=None, seed: int = 0,
              trns: bytes | None = None) -> bytes:
    """A PNG file of samples [h, w, ch], each row's filter drawn at random."""
    h, w, ch = samples.shape
    rng = np.random.default_rng(seed)
    bpp = max(1, depth * ch // 8)
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    data = b""
    for x0, y0, dx, dy in passes:
        sub = samples[y0::dy, x0::dx]
        if not sub.size:
            continue
        rows = pack_rows(sub, depth)
        data += filter_rows(rows, bpp, list(rng.integers(0, 5, rows.shape[0])))
    out = ip.PNG_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, int(interlace)))
    if palette is not None:
        out += chunk(b"PLTE", bytes(np.asarray(palette, np.uint8).ravel()))
    if trns is not None:
        out += chunk(b"tRNS", trns)
    comp = zlib.compress(data)
    # the image data over two IDAT chunks
    return out + chunk(b"IDAT", comp[: len(comp) // 2]) + chunk(b"IDAT", comp[len(comp) // 2 :]) + chunk(b"IEND", b"")


def pil_rgb(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def random_samples(h, w, color, depth, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << depth, (h, w, CHANNELS[color]), dtype=np.int64)


# every colour type and bit depth the standard allows, each plain and Adam7
CASES = [(c, d) for c, depths in ((0, (1, 2, 4, 8, 16)), (2, (8, 16)), (3, (1, 2, 4, 8)), (4, (8, 16)), (6, (8, 16)))
         for d in depths]


@pytest.mark.parametrize("interlace", [False, True])
@pytest.mark.parametrize("color,depth", CASES)
def test_built_files_decode_as_pil_converts_them(color, depth, interlace):
    """Every row filter, both layouts, sizes that leave Adam7 passes
    empty or ragged and rows with padding bits."""
    for i, (h, w) in enumerate([(13, 11), (1, 9), (7, 1), (3, 2)]):
        samples = random_samples(h, w, color, depth, seed=i)
        palette = None
        if color == 3:
            n = min(1 << depth, 7)  # short palettes: indices past PLTE read black
            palette = np.random.default_rng(i).integers(0, 256, (n, 3))
        data = build_png(samples, color, depth, interlace, palette, seed=i)
        np.testing.assert_array_equal(ip.decode_png(data), pil_rgb(data))


@pytest.mark.parametrize("mode,shape", [("RGB", (37, 53, 3)), ("RGBA", (29, 41, 4)), ("L", (31, 17)),
                                        ("LA", (19, 23, 2)), ("1", (21, 35)), ("P", (25, 30)), ("I;16", (18, 26))])
def test_pil_written_files_decode_as_pil_converts_them(mode, shape):
    """PIL's own files: its adaptive filters on smooth and noisy content."""
    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[: shape[0], : shape[1]]
    smooth = (xx * 7 + yy * 3) % 256
    for content in (smooth, rng.integers(0, 256, shape[:2])):
        if mode == "RGB" or mode == "RGBA" or mode == "LA":
            arr = np.stack([(content + 40 * k) % 256 for k in range(shape[2])], -1).astype(np.uint8)
            img = Image.fromarray(arr, mode)
        elif mode == "I;16":
            img = Image.frombytes("I;16", shape[::-1], (content * 300).astype("<u2").tobytes())
        elif mode == "1":
            img = Image.fromarray(content.astype(np.uint8) > 127)
        elif mode == "P":
            img = Image.fromarray(content.astype(np.uint8)).convert("P", palette=Image.Palette.ADAPTIVE, colors=13)
        else:
            img = Image.fromarray(content.astype(np.uint8))
        buf = io.BytesIO()
        img.save(buf, format="PNG")
        np.testing.assert_array_equal(ip.decode_png(buf.getvalue()), pil_rgb(buf.getvalue()))


def test_tRNS_is_ignored_as_convert_RGB_ignores_it():
    samples = random_samples(9, 12, 2, 8, seed=5)
    data = build_png(samples, 2, 8, trns=struct.pack(">HHH", 1, 2, 3))
    np.testing.assert_array_equal(ip.decode_png(data), pil_rgb(data))


def test_a_large_image_decodes_as_pil_converts_it():
    """900 x 900 RGB, as PIL writes it (the anti-diagonal unfilter on a
    long side)."""
    rng = np.random.default_rng(1)
    yy, xx = np.mgrid[:900, :900]
    arr = np.stack([(xx // 3 + yy // 5) % 256, (xx * yy // 97) % 256, rng.integers(0, 256, (900, 900))],
                   -1).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    np.testing.assert_array_equal(ip.decode_png(buf.getvalue()), arr)


def good_png() -> bytes:
    return build_png(random_samples(8, 8, 2, 8, seed=0), 2, 8)


@pytest.mark.parametrize("cut", [0.3, 0.6, 0.9, 0.99])
def test_truncated_files_raise(cut):
    data = good_png()
    with pytest.raises(ValueError, match="truncated PNG"):
        ip.decode_png(data[: int(len(data) * cut)])


def test_corrupt_files_raise_saying_what_is_wrong():
    data = bytearray(good_png())
    data[45] ^= 0xFF  # a byte of the first IDAT's payload
    with pytest.raises(ValueError, match="fails its CRC"):
        ip.decode_png(bytes(data))
    with pytest.raises(ValueError, match="not a PNG but a GIF file: image_gif.decode_gif reads it"):
        ip.decode_png(b"GIF89a" + b"\0" * 64)
    with pytest.raises(ValueError, match="unknown format.*item 16"):
        ip.decode_png(b"\x7fELF\x02\x01\x01" + b"\0" * 20)
    with pytest.raises(ValueError, match="not a PNG but a PPM file: image_netpbm.decode_netpbm reads it"):
        ip.decode_png(b"P6\n2 2\n255\n" + b"\0" * 12)
    with pytest.raises(ValueError, match="bit depth 16 with colour type 3"):
        ip.decode_png(ip.PNG_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", 2, 2, 16, 3, 0, 0, 0))
                      + chunk(b"IEND", b""))
    rows = bytes([7, 0, 0, 0, 7, 0, 0, 0])  # filter type 7
    bad_filter = (ip.PNG_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", 1, 2, 8, 2, 0, 0, 0))
                  + chunk(b"IDAT", zlib.compress(rows)) + chunk(b"IEND", b""))
    with pytest.raises(ValueError, match="filter type 7"):
        ip.decode_png(bad_filter)
    no_plte = (ip.PNG_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", 1, 1, 8, 3, 0, 0, 0))
               + chunk(b"IDAT", zlib.compress(b"\0\0")) + chunk(b"IEND", b""))
    with pytest.raises(ValueError, match="without PLTE"):
        ip.decode_png(no_plte)
    short = (ip.PNG_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", 4, 4, 8, 2, 0, 0, 0))
             + chunk(b"IDAT", zlib.compress(b"\0" * 13)) + chunk(b"IEND", b""))
    with pytest.raises(ValueError, match="fewer than its rows need"):
        ip.decode_png(short)


SIZES = [(56, 56), (28, 28), (10, 10), (1, 100), (100, 1), (3, 600), (224, 224), (600, 800), (900, 900), (780, 1000),
         (1080, 1920), (4000, 3000), (5000, 5000), (20000, 101), (1, 200), (1, 201), (3584, 3584), (3585, 3585)]


@pytest.mark.parametrize("min_pixels,max_pixels", [(3136, 12845056), (56 * 56, 28 * 28 * 1280), (100_000, 400_000)])
def test_smart_resize_equals_transformers(min_pixels, max_pixels):
    """Sizes at and across the min_pixels / max_pixels edges, and the
    aspect-ratio refusal (200 passes, 201 raises)."""
    from transformers.models.qwen2_vl.image_processing_qwen2_vl import smart_resize

    for h, w in SIZES:
        try:
            want = smart_resize(h, w, 28, min_pixels, max_pixels)
        except ValueError as e:
            with pytest.raises(ValueError, match="aspect ratio"):
                ip.smart_resize(h, w, 28, min_pixels, max_pixels)
            assert "aspect ratio" in str(e)
            continue
        assert ip.smart_resize(h, w, 28, min_pixels, max_pixels) == want, (h, w)


@pytest.mark.parametrize("size", [(57, 43), (61, 61), (120, 200), (200, 120), (13, 300)])
@pytest.mark.parametrize("factor", [0.1, 0.37, 0.5, 0.93, 1.0, 1.06, 2.0, 3.7])
def test_resize_equals_pil_bicubic_bit_for_bit(size, factor):
    rng = np.random.default_rng(int(factor * 100) + size[0])
    yy, xx = np.mgrid[: size[0], : size[1]]
    smooth = np.stack([(xx * 5 + yy * 2) % 256, (xx * yy) % 256, 128 + 0 * xx], -1)
    noisy = rng.integers(0, 256, (*size, 3))
    for arr in (smooth.astype(np.uint8), noisy.astype(np.uint8), noisy[..., 0].astype(np.uint8)):
        h, w = max(1, round(size[0] * factor)), max(1, round(size[1] * factor * 1.13))
        want = np.asarray(Image.fromarray(arr).resize((w, h), Image.BICUBIC))
        np.testing.assert_array_equal(ip.resize_bicubic(arr, h, w), want)


@pytest.mark.parametrize("shape", [(31, 47), (31, 47, 3), (29, 13, 4), (1, 1, 3), (64, 1, 3)])
def test_encoder_output_decodes_in_pil_to_its_input(shape):
    rng = np.random.default_rng(7)
    yy, xx = np.mgrid[: shape[0], : shape[1]]
    smooth = (xx * 9 + yy * 4) % 256
    for content in (smooth, rng.integers(0, 256, shape[:2])):
        ch = shape[2] if len(shape) == 3 else 1
        arr = ((content[..., None] + np.arange(ch) * 50) % 256).astype(np.uint8).reshape(shape)
        data = ip.encode_png(arr)
        np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))), arr)
        np.testing.assert_array_equal(ip.decode_png(data), pil_rgb(data))


def test_encoder_picks_every_filter_type():
    """The least-sum heuristic picks each of the five filters on content
    made for it, and the decoder reads them back."""
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[:64, :64]
    arr = np.stack([(xx * 3) % 256, (yy * 3) % 256, (xx + yy) % 256], -1).astype(np.uint8)
    arr[40:] = rng.integers(0, 256, (24, 64, 3))
    arr[20:30] = ((xx[20:30, :, None] * 7 + yy[20:30, :, None] * 11 + rng.integers(0, 3, (10, 64, 3))) % 256)
    data = ip.encode_png(arr)
    idat = b"".join(p for k, p in ip._chunks(data) if k == b"IDAT")
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(64, 1 + 64 * 3)
    assert set(raw[:, 0].tolist()) == {0, 1, 2, 3, 4}
    np.testing.assert_array_equal(ip.decode_png(data), arr)


# Qwen2.5-VL-3B-Instruct's preprocessor_config.json
QWEN25VL = {"min_pixels": 3136, "max_pixels": 12845056, "patch_size": 14, "temporal_patch_size": 2, "merge_size": 2,
            "image_mean": [0.48145466, 0.4578275, 0.40821073], "image_std": [0.26862954, 0.26130258, 0.27577711],
            "image_processor_type": "Qwen2VLImageProcessor", "processor_class": "Qwen2_5_VLProcessor"}


@pytest.mark.parametrize("config", [QWEN25VL, {**QWEN25VL, "min_pixels": 200_000, "max_pixels": 300_000},
                                    {"min_pixels": 3136, "max_pixels": 100_000}, {**QWEN25VL, "do_normalize": False},
                                    {**QWEN25VL, "do_rescale": False, "do_normalize": False},
                                    {**QWEN25VL, "rescale_factor": 0.5, "image_mean": [1.0, 2.0, 3.0]}])
def test_image_processor_equals_transformers_bit_for_bit(config):
    from transformers import Qwen2VLImageProcessor

    want_proc = Qwen2VLImageProcessor(**{k: v for k, v in config.items() if not k.endswith("_type")
                                         and k != "processor_class"})
    proc = ip.ImageProcessor.from_dict(config)
    rng = np.random.default_rng(11)
    for h, w in [(60, 80), (600, 800), (33, 200), (4, 4)]:
        arr = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        out = want_proc(images=[Image.fromarray(arr)], return_tensors="np")
        pixels, grid = proc(arr)
        assert list(grid) == out["image_grid_thw"][0].tolist()
        assert pixels.dtype == np.float32 and pixels.shape[1] == 1176
        np.testing.assert_array_equal(pixels, out["pixel_values"])


def test_other_resampling_filters_are_refused():
    with pytest.raises(ValueError, match="only bicubic"):
        ip.ImageProcessor.from_dict({"resample": 2})
