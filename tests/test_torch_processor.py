"""The port's ``HFVisualProcessor`` against the JAX package's, on a
Qwen2.5-VL directory this test writes (the fixture tokenizer with the
vision tokens added, Qwen2.5-VL's chat template, Qwen2.5-VL-3B's
``preprocessor_config.json``): for a raw image the JAX processor
(transformers' ``Qwen2_5_VLProcessor``) gives ids and features; the port
gives the same ids and the same features bit for bit, for a PIL image, PNG
and JPEG bytes, data URLs PIL wrote and uint8 arrays, and the same ids for
the features themselves; and for GIF, BMP, TIFF and WebP files as bytes
and data URLs, small ones PIL wrote and the committed chart fixtures. A
truncated PNG and a DDS raise; chartqa's message of an array reads alike
in both processors. The toy processors agree too."""

import base64
import io
import json
import shutil

import numpy as np
import pytest
from PIL import Image

from chip_smoke import vl_tokenizer_dir
from pipelinerl_tpu.domains.chartqa import chartqa as j_chartqa
from pipelinerl_tpu.inference.processor import HFVisualProcessor as JHFVisualProcessor
from pipelinerl_tpu.models.toy_tokenizer import ToyTokenizer as JToyTokenizer
from pipelinerl_tpu.models.toy_tokenizer import ToyVisualProcessor as JToyVisualProcessor
from pipelinerl_tpu_torch.domains.chartqa import chartqa as t_chartqa
from pipelinerl_tpu_torch.inference.processor import HFVisualProcessor, extract_images
from pipelinerl_tpu_torch.models.toy_tokenizer import ToyTokenizer, ToyVisualProcessor

# the vision tokens right after the fixture's vocabulary, so transformers'
# fast tokenizer holds them densely
TOKENS = {"<|vision_start|>": 540, "<|vision_end|>": 541, "<|image_pad|>": 542}
# Qwen2.5-VL-3B-Instruct's preprocessor_config.json
IMAGE_PROCESSOR = {"do_resize": True, "do_rescale": True, "do_normalize": True, "do_convert_rgb": True,
                   "image_mean": [0.48145466, 0.4578275, 0.40821073], "image_std": [0.26862954, 0.26130258, 0.27577711],
                   "min_pixels": 3136, "max_pixels": 12845056, "patch_size": 14, "temporal_patch_size": 2,
                   "merge_size": 2, "rescale_factor": 0.00392156862745098, "resample": 3}


@pytest.fixture(scope="module")
def vl_dir(tmp_path_factory):
    out = vl_tokenizer_dir(tmp_path_factory.mktemp("vl"), TOKENS)
    (out / "config.json").write_text(json.dumps({"architectures": ["Qwen2_5_VLForConditionalGeneration"],
                                                 "vision_config": {"spatial_merge_size": 2}}))
    (out / "preprocessor_config.json").write_text(json.dumps(IMAGE_PROCESSOR))
    return out


@pytest.fixture(scope="module")
def jax_processor(vl_dir):
    """The JAX package's ``HFVisualProcessor`` around transformers'
    ``Qwen2_5_VLProcessor`` for ``vl_dir``. ``AutoProcessor`` would also
    build the video processor, which needs torchvision (absent here); an
    image-only processor is built around a stand-in for it."""
    from transformers import Qwen2_5_VLProcessor, Qwen2TokenizerFast, Qwen2VLImageProcessor

    class NoVideo:
        merge_size, temporal_patch_size = 2, 2

    check = Qwen2_5_VLProcessor.check_argument_for_proper_class
    Qwen2_5_VLProcessor.check_argument_for_proper_class = lambda self, name, arg: None
    try:
        processor = Qwen2_5_VLProcessor(image_processor=Qwen2VLImageProcessor(**IMAGE_PROCESSOR),
                                        tokenizer=Qwen2TokenizerFast.from_pretrained(str(vl_dir)),
                                        video_processor=NoVideo(),
                                        chat_template=(vl_dir / "chat_template.jinja").read_text())
    finally:
        Qwen2_5_VLProcessor.check_argument_for_proper_class = check
    j = object.__new__(JHFVisualProcessor)
    j.processor = processor
    return j


def image(size, seed):
    return Image.fromarray((np.random.default_rng(seed).random((*size, 3)) * 255).astype(np.uint8))


def messages(images, system=True):
    user = [{"type": "image", "image": img} for img in images] + [{"type": "text", "text": "What is shown here?"}]
    return ([{"role": "system", "content": "Answer in a box."}] if system else []) + [
        {"role": "user", "content": user}]


@pytest.mark.parametrize("sizes,system", [([(100, 140)], True), ([(300, 200)], False), ([(56, 56), (90, 180)], True)])
def test_ids_for_features_equal_jax_ids_for_the_image(vl_dir, jax_processor, sizes, system):
    imgs = [image(s, i) for i, s in enumerate(sizes)]
    want_ids, feats = jax_processor(messages(imgs, system))
    grids = np.asarray(feats["image_grid_thw"])
    parts, start = [], 0
    for t, h, w in grids:  # each image's own features
        n = int(t * h * w)
        parts.append({"pixel_values": feats["pixel_values"][start : start + n], "image_grid_thw": [t, h, w]})
        start += n
    ids, visual = HFVisualProcessor(vl_dir)(messages(parts, system))
    assert ids == want_ids
    np.testing.assert_array_equal(visual["pixel_values"], feats["pixel_values"])
    np.testing.assert_array_equal(visual["image_grid_thw"], grids)
    assert ids.count(TOKENS["<|image_pad|>"]) == sum(int(t * h * w) // 4 for t, h, w in grids)


def test_text_only_prompt_has_no_features(vl_dir, jax_processor):
    msgs = [{"role": "user", "content": "hello"}]
    want, _ = jax_processor(msgs)
    ids, visual = HFVisualProcessor(vl_dir)(msgs)
    assert ids == want and visual is None


def png_bytes(img) -> bytes:
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return buf.getvalue()


def jpeg_bytes(img, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, format="JPEG", **kw)
    return buf.getvalue()


def data_url(img, fmt: str) -> str:
    buf = io.BytesIO()
    img.save(buf, format=fmt)
    return f"data:image/{fmt.lower()};base64," + base64.b64encode(buf.getvalue()).decode()


@pytest.mark.parametrize("case", ["truncated", "jpeg", "gif", "zeros", "ppm", "dds"])
def test_raw_images_refuse_naming_the_image_pipeline(vl_dir, jax_processor, case):
    """Truncated PNG bytes raise naming the fault, a DDS data URL raises
    naming ROADMAP item 16 (other image formats), and a zeros array and
    JPEG, GIF and PPM data URLs (which item 16 once held) give JAX's ids
    and features."""
    if case in ("zeros", "jpeg", "gif", "ppm"):
        part = ({"type": "image", "image": np.zeros((4, 4, 3), np.uint8)} if case == "zeros" else
                {"type": "image_url", "image_url": {"url": data_url(image((40, 30), 0), case.upper())}})
        want_ids, want = jax_processor([{"role": "user", "content": [part]}])
        ids, got = HFVisualProcessor(vl_dir)([{"role": "user", "content": [part]}])
        assert ids == want_ids
        np.testing.assert_array_equal(got["pixel_values"], want["pixel_values"])
        np.testing.assert_array_equal(got["image_grid_thw"], want["image_grid_thw"])
        return
    if case == "truncated":
        part, match = {"type": "image", "image": png_bytes(image((40, 30), 0))[:300]}, "truncated PNG"
    else:
        part, match = {"type": "image_url", "image_url": {"url": data_url(image((40, 30), 0), "DDS")}}, "item 16"
    with pytest.raises(ValueError, match=match):
        HFVisualProcessor(vl_dir)([{"role": "user", "content": [part]}])
    with pytest.raises(ValueError, match=match):
        extract_images([{"role": "user", "content": [part]}])


def raw_parts(img):
    """One image in each form the JAX processor takes: PNG and JPEG files
    (4:2:0 baseline and progressive), as bytes and data URLs."""
    data, jpeg = png_bytes(img), jpeg_bytes(img, quality=90)
    progressive = jpeg_bytes(img, quality=75, subsampling=2, progressive=True)
    return {"pil": img, "png": data, "url": "data:image/png;base64," + base64.b64encode(data).decode(),
            "jpeg": jpeg, "jpeg_url": "data:image/jpeg;base64," + base64.b64encode(jpeg).decode(),
            "progressive_url": "data:image/jpeg;base64," + base64.b64encode(progressive).decode()}


@pytest.mark.parametrize("form", ["pil", "png", "url", "jpeg", "jpeg_url", "progressive_url"])
@pytest.mark.parametrize("sizes,system", [([(100, 140)], True), ([(300, 200)], False), ([(56, 56), (90, 180)], True)])
def test_raw_images_give_jax_ids_and_features(vl_dir, jax_processor, form, sizes, system):
    """PIL images, PNG and JPEG bytes and PIL-written data URLs: ids and
    ``pixel_values`` equal to JAX's bit for bit (the same decode, the same
    integer resize and the same float32 arithmetic in the same order)."""
    imgs = [raw_parts(image(s, i))[form] for i, s in enumerate(sizes)]
    if form.endswith("url"):
        user = [{"type": "image_url", "image_url": {"url": u}} for u in imgs]
        msgs = ([{"role": "system", "content": "Answer in a box."}] if system else []) + [
            {"role": "user", "content": user + [{"type": "text", "text": "What is shown here?"}]}]
    else:
        msgs = messages(imgs, system)
    want_ids, want = jax_processor(msgs)
    ids, got = HFVisualProcessor(vl_dir)(msgs)
    assert ids == want_ids
    np.testing.assert_array_equal(got["pixel_values"], want["pixel_values"])
    np.testing.assert_array_equal(got["image_grid_thw"], want["image_grid_thw"])


@pytest.mark.parametrize("shape", [(64, 90), (64, 90, 3), (77, 50, 4)])
def test_uint8_arrays_give_jax_ids_and_features(vl_dir, jax_processor, shape):
    """[H, W] as L, [H, W, 3] as RGB, [H, W, 4] as RGBA (alpha dropped),
    as ``Image.fromarray`` reads them."""
    arr = np.random.default_rng(5).integers(0, 256, shape).astype(np.uint8)
    msgs = messages([arr])
    want_ids, want = jax_processor(msgs)
    ids, got = HFVisualProcessor(vl_dir)(msgs)
    assert ids == want_ids
    np.testing.assert_array_equal(got["pixel_values"], want["pixel_values"])


@pytest.mark.parametrize("mode", ["L", "LA", "RGBA", "1", "P"])
def test_pil_images_of_other_modes_give_jax_features(vl_dir, jax_processor, mode):
    """A PIL image reaches the port through ``__array_interface__`` (a "P"
    image with its ``getpalette()``), converted as ``convert("RGB")``
    converts it, as transformers does for the JAX package."""
    rgb = np.random.default_rng(6).integers(0, 256, (70, 95, 3)).astype(np.uint8)
    img = Image.fromarray(rgb)
    img = img.quantize(colors=23) if mode == "P" else img.convert(mode)
    msgs = messages([img])
    want_ids, want = jax_processor(msgs)
    ids, got = HFVisualProcessor(vl_dir)(msgs)
    assert ids == want_ids
    np.testing.assert_array_equal(got["pixel_values"], want["pixel_values"])


def test_a_raw_image_needs_the_preprocessor_config(vl_dir, tmp_path):
    bare = tmp_path / "bare"
    shutil.copytree(vl_dir, bare)
    (bare / "preprocessor_config.json").unlink()
    with pytest.raises(ValueError, match="preprocessor_config.json"):
        HFVisualProcessor(bare)(messages([np.zeros((28, 28, 3), np.uint8)]))


def test_chartqa_message_of_an_array_reads_alike_in_both_processors(vl_dir, jax_processor):
    """The port's ``multimodal_message`` (its own PNG encoder in a data
    URL) gives, through either processor, the features JAX's message of
    the same array gives through JAX's."""
    arr = np.random.default_rng(9).integers(0, 256, (120, 170, 3)).astype(np.uint8)
    port_msg = [t_chartqa.multimodal_message(arr, "How tall is the bar?")]
    jax_msg = [j_chartqa.multimodal_message(Image.fromarray(arr), "How tall is the bar?")]
    assert port_msg[0]["content"][0]["image_url"]["url"].startswith("data:image/png;base64,")
    want_ids, want = jax_processor(jax_msg)
    for ids, got in (jax_processor(port_msg), HFVisualProcessor(vl_dir)(port_msg)):
        assert ids == want_ids
        np.testing.assert_array_equal(got["pixel_values"], want["pixel_values"])
        np.testing.assert_array_equal(got["image_grid_thw"], want["image_grid_thw"])


def format_bytes(img, fmt: str) -> bytes:
    """``img`` as a file of one of the formats the port reads beside PNG
    and JPEG, written by PIL (the BMP by the BMP tests' RLE8 encoder)."""
    from tests.test_torch_bmp import encode_bmp

    if fmt == "bmp_rle8":
        quantized = img.convert("RGB").quantize(32)
        table = np.asarray(quantized.getpalette(), np.uint8).reshape(-1, 3)
        return encode_bmp(np.asarray(quantized), 8, compression=1, table=table)
    kw = {"gif": ("GIF", {}), "tiff_lzw": ("TIFF", dict(compression="tiff_lzw", tiffinfo={317: 2})),
          "tiff_jpeg": ("TIFF", dict(compression="jpeg", quality=85)), "webp_lossless": ("WEBP", dict(lossless=True)),
          "webp_lossy_alpha": ("WEBP", dict(quality=80))}[fmt]
    buf = io.BytesIO()
    (img.convert("RGBA") if fmt == "webp_lossy_alpha" else img).save(buf, kw[0], **kw[1])
    return buf.getvalue()


NEW_FORMATS = ["gif", "bmp_rle8", "tiff_lzw", "tiff_jpeg", "webp_lossless", "webp_lossy_alpha"]


@pytest.mark.parametrize("form", ["bytes", "url"])
@pytest.mark.parametrize("fmt", NEW_FORMATS)
def test_other_formats_give_jax_ids_and_features(vl_dir, jax_processor, fmt, form):
    """GIF, BMP, TIFF and WebP files at 64x64 and under, as bytes and as
    data URLs: the JAX package opens them with PIL, the port with its own
    decoders; ids and features equal bit for bit."""
    rgba = np.random.default_rng(11).integers(0, 256, (48, 64, 4)).astype(np.uint8)
    rgba[..., 3] = np.linspace(0, 255, 64, dtype=np.uint8)[None, :]
    img = Image.fromarray(rgba).convert("RGB") if fmt != "webp_lossy_alpha" else Image.fromarray(rgba, "RGBA")
    data = format_bytes(img, fmt)
    part = ({"type": "image", "image": data} if form == "bytes" else
            {"type": "image_url", "image_url": {"url": "data:image/x;base64," + base64.b64encode(data).decode()}})
    msgs = [{"role": "user", "content": [part, {"type": "text", "text": "What is shown here?"}]}]
    want_ids, want = jax_processor(msgs)
    ids, got = HFVisualProcessor(vl_dir)(msgs)
    assert ids == want_ids
    np.testing.assert_array_equal(got["pixel_values"], want["pixel_values"])
    np.testing.assert_array_equal(got["image_grid_thw"], want["image_grid_thw"])


@pytest.mark.parametrize("name", ["chart_600x800_lossy_alpha.webp", "chart_480x640.gif", "chart_480x640_rle8.bmp",
                                  "chart_480x640_lzw_predictor.tif", "chart_480x640_jpeg.tif",
                                  "chart_480x640_lossless.webp", "chart_256x256.ico", "chart_96x128.cur",
                                  "chart_240x320.ppm", "chart_240x320_rle.tga", "chart_240x320.qoi",
                                  "chart_240x320.pcx", "chart_240x320_rle.sgi", "chart_240x320.xbm",
                                  "chart_240x320.xpm"])
def test_committed_chart_fixtures_give_jax_ids_and_features(vl_dir, jax_processor, name):
    """One larger image per format: the committed chart files phase 26
    sends, as data URLs through both processors."""
    from tests.test_torch_image_fixtures import FIXTURES

    url = "data:image/x;base64," + base64.b64encode((FIXTURES / name).read_bytes()).decode()
    msgs = [{"role": "user", "content": [{"type": "image_url", "image_url": {"url": url}},
                                         {"type": "text", "text": "What is the value of the third bar?"}]}]
    want_ids, want = jax_processor(msgs)
    ids, got = HFVisualProcessor(vl_dir)(msgs)
    assert ids == want_ids
    np.testing.assert_array_equal(got["pixel_values"], want["pixel_values"])
    np.testing.assert_array_equal(got["image_grid_thw"], want["image_grid_thw"])


def test_toy_processors_equal_jax():
    rng = np.random.default_rng(0)
    parts = [{"type": "image", "image": {"pixel_values": rng.normal(size=(16, 12)).astype(np.float32),
                                          "image_grid_thw": [1, 4, 4]}},
             {"type": "text", "text": "press"},
             {"type": "image", "image": {"pixel_values": rng.normal(size=(24, 12)).astype(np.float32),
                                          "image_grid_thw": [1, 4, 6]}}]
    msgs = [{"role": "system", "content": "s"}, {"role": "user", "content": parts}]
    want_ids, want = JToyVisualProcessor(JToyTokenizer(), 2)(msgs)
    ids, got = ToyVisualProcessor(ToyTokenizer(), 2)(msgs)
    assert ids == want_ids
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


# -- raw images of every dtype and mode, and the formats ported after WebP -----


RAW_DTYPES = ["int8", "uint16", "int16", "int32", "uint32", "float32", "float64"]
RAW_MODES = ["CMYK", "YCbCr", "HSV", "I;16", "I", "F", "PA", "RGBX", "RGBa"]


def raw_array(dtype: str, shape=(64, 90), seed: int = 12) -> np.ndarray:
    """A 2-D array of ``dtype`` whose values run past [0, 255] both ways."""
    rng = np.random.default_rng(seed)
    values = rng.standard_normal(shape) * 150 + 120
    if np.dtype(dtype).kind == "f":
        values.flat[:4] = [np.nan, np.inf, -1e9, 254.9]
        return values.astype(dtype)
    info = np.iinfo(dtype)
    return np.clip(np.round(values), info.min, info.max).astype(dtype)


def mode_image(mode: str, shape=(64, 90), seed: int = 13) -> Image.Image:
    """A PIL image in ``mode`` of random samples (a random palette for
    PA)."""
    rng = np.random.default_rng(seed)
    if mode in ("I;16", "I", "F"):
        values = raw_array({"I;16": "<u2", "I": "<i4", "F": "<f4"}[mode].replace("<", ""), shape, seed)
        image = Image.new(mode, shape[::-1])
        image.frombytes(values.astype({"I;16": "<u2", "I": "<i4", "F": "<f4"}[mode]).tobytes())
        return image
    channels = {"CMYK": 4, "YCbCr": 3, "HSV": 3, "PA": 2, "RGBX": 4, "RGBa": 4}[mode]
    image = Image.frombytes(mode, shape[::-1], rng.integers(0, 256, (*shape, channels), dtype=np.uint8).tobytes())
    if mode == "PA":
        image.putpalette(rng.integers(0, 256, 3 * 200).tolist())
    return image


def assert_same_features(vl_dir, jax_processor, part):
    msgs = [{"role": "user", "content": [part, {"type": "text", "text": "What is shown here?"}]}]
    want_ids, want = jax_processor(msgs)
    ids, got = HFVisualProcessor(vl_dir)(msgs)
    assert ids == want_ids
    np.testing.assert_array_equal(got["pixel_values"], want["pixel_values"])
    np.testing.assert_array_equal(got["image_grid_thw"], want["image_grid_thw"])


@pytest.mark.parametrize("dtype", RAW_DTYPES)
def test_arrays_of_every_dtype_give_jax_features(vl_dir, jax_processor, dtype):
    """2-D arrays PIL reads as I;16, I and F: ``Image.fromarray`` then
    ``convert("RGB")`` in JAX, ``array_to_rgb`` in the port."""
    assert_same_features(vl_dir, jax_processor, {"type": "image", "image": raw_array(dtype)})


@pytest.mark.parametrize("mode", RAW_MODES)
def test_pil_images_of_every_mode_give_jax_features(vl_dir, jax_processor, mode):
    assert_same_features(vl_dir, jax_processor, {"type": "image", "image": mode_image(mode)})


def raster_file(fmt: str) -> bytes:
    """A 48x64 image in each format ported after WebP: PIL writes what it
    writes, the tests' encoders the rest."""
    from tests.test_torch_ico import dib_entry, encode_icon
    from tests.test_torch_qoi_pcx_sgi import encode_sgi
    from tests.test_torch_xbm_xpm import encode_xpm

    rng = np.random.default_rng(14)
    rgb = rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)
    if fmt == "cur":
        return encode_icon([(64, 48, 0, 24, dib_entry(rgb, 24, mask=False))], kind=2)
    if fmt == "sgi_rle":
        return encode_sgi(np.moveaxis(rgb, -1, 0).astype(np.int64), 1, True)
    if fmt == "xpm":
        return encode_xpm(rng.integers(0, 40, (48, 64)), ["#%06x" % v for v in rng.integers(0, 2**24, 40)], 1)
    image, pil_fmt, kw = Image.fromarray(rgb), fmt.split("_")[0].upper(), {}
    if fmt == "ico_bmp":
        kw = {"sizes": [(32, 32), (64, 64)], "bitmap_format": "bmp"}
    elif fmt == "ppm_16":
        image, pil_fmt = Image.fromarray(rng.integers(0, 65536, (48, 64), dtype=np.uint16)), "PPM"
    elif fmt == "tga_rle":
        kw = {"compression": "tga_rle"}
    elif fmt == "pcx_p":
        image = image.quantize(60)
    elif fmt == "xbm":
        image = image.convert("1")
    buf = io.BytesIO()
    image.save(buf, pil_fmt, **kw)
    return buf.getvalue()


RASTER_FORMATS = ["ico_bmp", "cur", "ppm", "ppm_16", "tga_rle", "qoi", "pcx_p", "sgi_rle", "xbm", "xpm"]


@pytest.mark.parametrize("form", ["bytes", "url"])
@pytest.mark.parametrize("fmt", RASTER_FORMATS)
def test_raster_formats_give_jax_ids_and_features(vl_dir, jax_processor, fmt, form):
    data = raster_file(fmt)
    part = ({"type": "image", "image": data} if form == "bytes" else
            {"type": "image_url", "image_url": {"url": "data:image/x;base64," + base64.b64encode(data).decode()}})
    assert_same_features(vl_dir, jax_processor, part)


def refused(case: str):
    """What PIL itself refuses: an int64 array, a La image, an EPS without
    Ghostscript, the stub formats, bytes no plugin (TGA last) accepts."""
    if case == "int64":
        return np.zeros((8, 8), np.int64)
    if case == "La":
        return Image.fromarray(np.zeros((8, 8, 2), np.uint8), "La")
    return {"eps": b"%!PS-Adobe-3.0 EPSF-3.0\n%%BoundingBox: 0 0 16 16\nshowpage\n%%EOF\n",
            "bufr": b"BUFR" + bytes(60), "grib": b"GRIB" + bytes(60), "hdf5": b"\x89HDF\r\n\x1a\n" + bytes(60),
            "mpeg": b"\x00\x00\x01\xb3\x01\x00\x10\x13" + bytes(60),
            "wmf": b"\xd7\xcd\xc6\x9a\x00\x00" + bytes(16) + b"\x01\x00\x09\x00\x00\x03" + bytes(60),
            "headerless": b"\x00\x02\x07" + bytes(9) + b"\x10\x00\x10\x00\x18\x00" + bytes(800),
            "headerless_depth": b"\x00\x00\x02" + bytes(9) + b"\x10\x00\x10\x00\x0c\x00" + bytes(800)}[case]


@pytest.mark.parametrize("case", ["int64", "La", "eps", "bufr", "grib", "hdf5", "mpeg", "wmf", "headerless",
                                  "headerless_depth"])
def test_what_pil_refuses_both_processors_refuse(vl_dir, jax_processor, case):
    """Both packages fail on each; the port names ROADMAP item 16."""
    source = refused(case)
    if isinstance(source, bytes):
        with pytest.raises(Exception):
            Image.open(io.BytesIO(source)).convert("RGB")
    msgs = [{"role": "user", "content": [{"type": "image", "image": source}, {"type": "text", "text": "q"}]}]
    with pytest.raises(Exception):
        jax_processor(msgs)
    with pytest.raises(ValueError, match="item 16"):
        HFVisualProcessor(vl_dir)(msgs)
