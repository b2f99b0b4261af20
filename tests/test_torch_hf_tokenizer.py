"""The port's byte-level BPE tokenizer (``models/hf_tokenizer.py``) against
``AutoTokenizer`` on the committed fixture (``ByteLevel`` with GPT-2's
pattern, no normalizer) and on a Qwen2-style tokenizer the ``tokenizers``
library builds here (``Split`` + ``ByteLevel(use_regex=false)`` + ``NFC``):
ids, text and chat-template output must be equal, exactly."""

from pathlib import Path

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from pipelinerl_tpu.models.hf_fixture import CHATML_TEMPLATE, _corpus
from pipelinerl_tpu_torch.models.hf_tokenizer import HFTokenizer

FIXTURE = Path(__file__).resolve().parents[1] / "pipelinerl_tpu_torch" / "fixtures" / "hf_tokenizer"
# Qwen2's pre-tokenizer pattern (its tokenizer.json ``Split`` regex)
QWEN2_PATTERN = (
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+"
)
SPECIALS = ["<|endoftext|>", "<|im_start|>", "<|im_end|>"]
EDGE_TEXTS = [
    "", " ", "  leading and trailing  ", "tabs\tand\nnew\r\nlines\n\n\n", "a\x1cb\x1dc \x85d e　f",
    "héllo wörld, ÀÉÎ ñ — “quotes” ’s", "日本語のテキスト １２３ ٣٤", "emoji 🙂🚀 mixed 😀x", "é vs é (NFC)",
    "I'm you're he'll they've it's I'D 'S ſ's", "<|im_start|>user\nsay x<|im_end|>\n", "x<|im_end|><|im_end|>y",
    "<|im_start<|im_end|>|>", "numbers 1234567890 3.14 -42 1e-5", "!!! ??? ... ,,, ;;; \\\\ //",
]
MESSAGES = [
    [{"role": "user", "content": "say x"}],
    [{"role": "system", "content": "You are a helpful assistant."}, {"role": "user", "content": "Guess the number."},
     {"role": "assistant", "content": "Is it 42?"}, {"role": "user", "content": "Too low. Guess again."}],
    [{"role": "user", "content": [{"type": "text", "text": "part one "}, {"type": "image"},
                                  {"type": "text", "text": "part two"}]}],
]


@pytest.fixture(scope="module")
def fixture_pair():
    from transformers import AutoTokenizer

    return HFTokenizer(FIXTURE), AutoTokenizer.from_pretrained(str(FIXTURE))


@pytest.fixture(scope="module")
def qwen2_style_pair(tmp_path_factory):
    """A tokenizer assembled as Qwen2's is, trained here on the fixture's
    corpus, and saved with a ChatML template."""
    from tokenizers import Regex, Tokenizer, decoders, models, normalizers, pre_tokenizers, trainers
    from transformers import AutoTokenizer, PreTrainedTokenizerFast

    tok = Tokenizer(models.BPE(unk_token=None))
    tok.normalizer = normalizers.NFC()
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(QWEN2_PATTERN), behavior="isolated", invert=False),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False),
    ])
    tok.decoder = decoders.ByteLevel()
    trainer = trainers.BpeTrainer(vocab_size=700, special_tokens=[], show_progress=False,
                                  initial_alphabet=pre_tokenizers.ByteLevel.alphabet())
    tok.train_from_iterator(_corpus() + EDGE_TEXTS, trainer)
    tok.add_special_tokens(SPECIALS)
    fast = PreTrainedTokenizerFast(tokenizer_object=tok, eos_token="<|im_end|>", pad_token="<|endoftext|>")
    fast.chat_template = CHATML_TEMPLATE
    path = tmp_path_factory.mktemp("qwen2_style")
    fast.save_pretrained(str(path))
    return HFTokenizer(path), AutoTokenizer.from_pretrained(str(path))


@pytest.fixture(scope="module")
def options_pair(tmp_path_factory):
    """The fixture with the options it leaves off turned on: the config's
    ``add_prefix_space`` (transformers sets a top-level ByteLevel's from it,
    whatever ``tokenizer.json`` says), BPE's ``ignore_merges`` (a whole
    pre-token found in the vocabulary is one id) and
    ``clean_up_tokenization_spaces``."""
    import json
    import shutil

    from transformers import AutoTokenizer

    path = tmp_path_factory.mktemp("options")
    for name in ("tokenizer.json", "tokenizer_config.json", "chat_template.jinja", "special_tokens_map.json"):
        shutil.copyfile(FIXTURE / name, path / name)
    spec = json.loads((path / "tokenizer.json").read_text())
    spec["model"]["ignore_merges"] = True
    (path / "tokenizer.json").write_text(json.dumps(spec))
    config = json.loads((path / "tokenizer_config.json").read_text())
    config.update(clean_up_tokenization_spaces=True, add_prefix_space=True)
    (path / "tokenizer_config.json").write_text(json.dumps(config))
    return HFTokenizer(path), AutoTokenizer.from_pretrained(str(path))


@pytest.fixture(params=["fixture", "qwen2_style", "options"])
def pair(request):
    return request.getfixturevalue(f"{request.param}_pair")


def test_fixture_files_are_what_build_hf_tokenizer_saves(fixture_pair, tmp_path):
    """The committed files are what ``build_hf_tokenizer(1024)`` saves: 537
    BPE entries, 281 merges, 3 specials, eos ``<|im_end|>``, pad
    ``<|endoftext|>``."""
    import json

    from pipelinerl_tpu.models.hf_fixture import build_hf_tokenizer

    build_hf_tokenizer(1024).save_pretrained(str(tmp_path))
    for name in ("tokenizer.json", "tokenizer_config.json", "special_tokens_map.json"):
        assert json.loads((tmp_path / name).read_text()) == json.loads((FIXTURE / name).read_text()), name
    assert (tmp_path / "chat_template.jinja").read_text() == (FIXTURE / "chat_template.jinja").read_text()
    ours, ref = fixture_pair
    assert (len(ours), len(ours.vocab), len(ours.ranks), len(ours.added)) == (540, 537, 281, 3)
    assert (ours.eos_token_id, ours.pad_token_id) == (ref.eos_token_id, ref.pad_token_id) == (539, 537)
    assert ours.chat_template == CHATML_TEMPLATE


def test_len_eos_pad(pair):
    ours, ref = pair
    assert len(ours) == len(ref)
    assert ours.eos_token_id == ref.eos_token_id and ours.pad_token_id == ref.pad_token_id


def test_encode_decode_corpus_and_edges(pair):
    ours, ref = pair
    for text in _corpus() + EDGE_TEXTS:
        ids = ours.encode(text)
        assert ids == ref.encode(text), text
        for skip in (False, True):
            assert ours.decode(ids, skip_special_tokens=skip) == ref.decode(ids, skip_special_tokens=skip), text


@settings(max_examples=150, deadline=None)
@given(parts=st.lists(st.one_of(st.text(max_size=24), st.sampled_from(SPECIALS),
                                st.sampled_from([" ", "  ", "\n", "\t", "\r\n", "   \n "])), max_size=8))
def test_encode_decode_random_text(fixture_pair, qwen2_style_pair, parts):
    text = "".join(parts)
    for ours, ref in (fixture_pair, qwen2_style_pair):
        ids = ours.encode(text)
        assert ids == ref.encode(text)
        assert ours.decode(ids) == ref.decode(ids)
        assert ours.decode(ids, skip_special_tokens=True) == ref.decode(ids, skip_special_tokens=True)


@settings(max_examples=100, deadline=None)
@given(ids=st.lists(st.integers(0, 560), max_size=40))
def test_decode_arbitrary_ids(fixture_pair, ids):
    """Ids that split a UTF-8 sequence, special ids and ids past the
    vocabulary decode as the library decodes them."""
    ours, ref = fixture_pair
    for skip in (False, True):
        assert ours.decode(ids, skip_special_tokens=skip) == ref.decode(ids, skip_special_tokens=skip)


@pytest.mark.parametrize("messages", MESSAGES, ids=["one_turn", "four_turns", "content_parts"])
@pytest.mark.parametrize("add_generation_prompt", [False, True])
def test_apply_chat_template(pair, messages, add_generation_prompt):
    ours, ref = pair
    for tokenize in (False, True):
        assert ours.apply_chat_template(messages, add_generation_prompt=add_generation_prompt, tokenize=tokenize) == \
            ref.apply_chat_template(messages, add_generation_prompt=add_generation_prompt, tokenize=tokenize)


def test_save_pretrained_round_trip(fixture_pair, tmp_path):
    ours, _ = fixture_pair
    ours.save_pretrained(tmp_path)
    again = HFTokenizer(tmp_path)
    text = "<|im_start|>user\nIs it 42?<|im_end|>"
    assert again.encode(text) == ours.encode(text) and len(again) == len(ours)


@pytest.mark.parametrize("component", ["model", "normalizer", "pre_tokenizer", "decoder", "post_processor"])
def test_unsupported_components_raise_and_name_themselves(tmp_path, component):
    import json
    import shutil

    for name in ("tokenizer.json", "tokenizer_config.json"):
        shutil.copyfile(FIXTURE / name, tmp_path / name)
    spec = json.loads((tmp_path / "tokenizer.json").read_text())
    spec[component] = {"model": {"type": "WordPiece", "vocab": {}}, "normalizer": {"type": "Lowercase"},
                       "pre_tokenizer": {"type": "Whitespace"}, "decoder": {"type": "WordPiece"},
                       "post_processor": {"type": "BertProcessing", "sep": ["<|im_end|>", 539],
                                          "cls": ["<|im_start|>", 538]}}[component]
    (tmp_path / "tokenizer.json").write_text(json.dumps(spec))
    with pytest.raises(NotImplementedError, match=spec[component]["type"]):
        HFTokenizer(tmp_path)
