"""The port's ``HFVisualProcessor`` against the JAX package's, on a
Qwen2.5-VL directory this test writes (the fixture tokenizer with the
vision tokens added, Qwen2.5-VL's chat template, an image processor
config): for a raw image the JAX processor (transformers'
``Qwen2_5_VLProcessor``) gives ids and features; the port, given those
features, gives the same ids. A raw image refuses in the port and names
the image pipeline's ROADMAP item. The toy processors agree too."""

import json

import numpy as np
import pytest
from PIL import Image

from chip_smoke import vl_tokenizer_dir
from pipelinerl_tpu.inference.processor import HFVisualProcessor as JHFVisualProcessor
from pipelinerl_tpu.models.toy_tokenizer import ToyTokenizer as JToyTokenizer
from pipelinerl_tpu.models.toy_tokenizer import ToyVisualProcessor as JToyVisualProcessor
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


@pytest.mark.parametrize("part", [
    {"type": "image", "image": b"\x89PNG\r\n"},
    {"type": "image_url", "image_url": {"url": "data:image/png;base64,AAAA"}},
    {"type": "image", "image": np.zeros((4, 4, 3), np.uint8)},
])
def test_raw_images_refuse_naming_the_image_pipeline(vl_dir, part):
    with pytest.raises(ValueError, match="item 13"):
        HFVisualProcessor(vl_dir)([{"role": "user", "content": [part]}])
    with pytest.raises(ValueError, match="item 13"):
        extract_images([{"role": "user", "content": [part]}])


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
