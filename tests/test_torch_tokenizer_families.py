"""The port's tokenizer (``models/hf_tokenizer.py``) on the layouts of the
Llama 3 and SentencePiece (Llama 2, Mistral) families, against
``AutoTokenizer``: each is built here by the ``tokenizers`` library, trained
on the fixture corpus with that family's components, and saved by
transformers. Ids with and without special tokens, decoded text, chat
templates, ``len`` and special ids must be equal, exactly.

The three committed fixtures under ``pipelinerl_tpu_torch/fixtures/`` are
what the builders below save (the card host has no ``tokenizers``);
``python tests/test_torch_tokenizer_families.py`` writes them again, with
``tokenizer_ids.json``, the ids ``AutoTokenizer`` gives for fixed prompts.
"""

import contextlib
import json
import os
import shutil
import sys
from pathlib import Path

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from pipelinerl_tpu.models.hf_fixture import _corpus
from pipelinerl_tpu_torch.models.hf_tokenizer import HFTokenizer

FIXTURES = Path(__file__).resolve().parents[1] / "pipelinerl_tpu_torch" / "fixtures"
FAMILIES = ("llama3_tokenizer", "sp_tokenizer", "sp_metaspace_tokenizer")
FILES = ("tokenizer.json", "tokenizer_config.json", "special_tokens_map.json", "chat_template.jinja")
# Llama 3's pre-tokenizer pattern (its tokenizer.json ``Split`` regex)
LLAMA3_PATTERN = (
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+"
)
# Llama 3.1/3.2's 256 special tokens at their published ids
LLAMA3_SPECIALS = {
    128000: "<|begin_of_text|>", 128001: "<|end_of_text|>", 128004: "<|finetune_right_pad_id|>",
    128006: "<|start_header_id|>", 128007: "<|end_header_id|>", 128008: "<|eom_id|>", 128009: "<|eot_id|>",
    128010: "<|python_tag|>",
}
_reserved = iter(range(256))
LLAMA3_SPECIALS = {i: LLAMA3_SPECIALS.get(i) or f"<|reserved_special_token_{next(_reserved)}|>"
                   for i in range(128000, 128256)}
SP_SPECIALS = ["<unk>", "<s>", "</s>"]
# text the byte-level layouts know only as bytes and the SentencePiece ones
# only through byte fallback, and spacing each treats its own way
EXTRA_TEXTS = [
    "", " ", "  leading and trailing  ", "tabs\tand\nnew\r\nlines\n\n\n", "héllo wörld, ÀÉÎ ñ — “quotes” ’s",
    "日本語のテキスト １２３ ٣٤", "emoji 🙂🚀 mixed 😀x", "é vs é (NFC)", "I'm you're he'll they've it's I'D",
    "numbers 1234567890 3.14 -42 1e-5", "!!! ??? ... ,,, ;;; \\\\ //", "▁already▁metaspace ▁ x", "a  b   c",
    "<0x41> looks like a byte token", "<s>say x</s>", " <s> spaced </s> ", "x<unk>y", "<|begin_of_text|>Hi",
    "<|start_header_id|>user<|end_header_id|>\n\nhello<|eot_id|>", "<|eot_id|><|eot_id|>",
]
TOOLS = [{"type": "function", "function": {
    "name": "get_weather", "description": "The weather in a city.",
    "parameters": {"type": "object", "properties": {"city": {"type": "string"}}, "required": ["city"]}}}]
LLAMA3_MESSAGES = {
    "one_turn": [{"role": "user", "content": "say x"}],
    "system": [{"role": "system", "content": "You are a helpful assistant."},
               {"role": "user", "content": "Guess the number."}, {"role": "assistant", "content": "Is it 42?"},
               {"role": "user", "content": "Too low. Guess again."}],
    "tool_call": [{"role": "user", "content": "Weather in Paris?"},
                  {"role": "assistant", "tool_calls": [{"type": "function", "function": {
                      "name": "get_weather", "arguments": {"city": "Paris"}}}]},
                  {"role": "tool", "content": {"temperature": 21}}],
}
MISTRAL_MESSAGES = {
    "one_turn": [{"role": "user", "content": "say x"}],
    "system": [{"role": "system", "content": "You are a helpful assistant."},
               {"role": "user", "content": "Guess the number."}, {"role": "assistant", "content": "Is it 42?"},
               {"role": "user", "content": "Too low. Guess again."}],
    "tool_call": [{"role": "user", "content": "Weather in Paris?"},
                  {"role": "assistant", "tool_calls": [{"id": "abcdefghi", "function": {
                      "name": "get_weather", "arguments": {"city": "Paris"}}}]},
                  {"role": "tool", "tool_call_id": "abcdefghi", "content": "21 C"},
                  {"role": "assistant", "content": "It is 21 C."}, {"role": "user", "content": "Thanks"}],
}
NOT_ALTERNATING = [{"role": "user", "content": "one"}, {"role": "user", "content": "two"}]
# the prompts whose ids tokenizer_ids.json holds
ENCODE_PROMPTS = ["say x", "Guess the number between 0 and 100.", "héllo 日本 🙂 <s> x", "  two  spaces"]
DATE_STRING = "26 Jul 2024"


def _training_text() -> list[str]:
    return _corpus() + [t for t in EXTRA_TEXTS if "<" not in t]


def build_llama3_tokenizer():
    """Llama 3's layout: byte-level BPE with ``ignore_merges``, the Split
    pattern before ByteLevel, ``Sequence[ByteLevel, TemplateProcessing]``
    adding ``<|begin_of_text|>``, and the 256 specials at 128,000-128,255
    (in the model's vocabulary too, so the library keeps their ids)."""
    from tokenizers import Regex, Tokenizer, decoders, models, pre_tokenizers, processors, trainers
    from transformers import PreTrainedTokenizerFast

    tok = Tokenizer(models.BPE(unk_token=None))
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(LLAMA3_PATTERN), behavior="isolated", invert=False),
        pre_tokenizers.ByteLevel(add_prefix_space=False, trim_offsets=True, use_regex=False),
    ])
    tok.decoder = decoders.ByteLevel()
    tok.post_processor = processors.Sequence([
        processors.ByteLevel(trim_offsets=False),
        processors.TemplateProcessing(single="<|begin_of_text|> $A", pair="<|begin_of_text|> $A <|begin_of_text|> $B:1",
                                      special_tokens=[("<|begin_of_text|>", 128000)]),
    ])
    trainer = trainers.BpeTrainer(vocab_size=900, special_tokens=[], show_progress=False,
                                  initial_alphabet=pre_tokenizers.ByteLevel.alphabet())
    tok.train_from_iterator(_training_text(), trainer)
    spec = json.loads(tok.to_str())
    spec["model"]["ignore_merges"] = True
    spec["model"]["vocab"].update({content: i for i, content in LLAMA3_SPECIALS.items()})
    spec["added_tokens"] = [{"id": i, "content": content, "single_word": False, "lstrip": False, "rstrip": False,
                             "normalized": False, "special": True} for i, content in LLAMA3_SPECIALS.items()]
    with quiet():
        fast = PreTrainedTokenizerFast(tokenizer_object=Tokenizer.from_str(json.dumps(spec)),
                                       bos_token="<|begin_of_text|>", eos_token="<|end_of_text|>",
                                       clean_up_tokenization_spaces=True, model_max_length=131072)
    fast.chat_template = (FIXTURES / "chat_template_llama3.jinja").read_text()
    return fast


def build_sp_tokenizer(layout: str = "prepend", *, missing_bytes: tuple[int, ...] = (),
                       prepend_scheme: str = "first", split: bool = False, metaspace_decoder: bool = False,
                       llama_class: bool = True, **config):
    """A SentencePiece-style BPE: ``<unk>``, ``<s>``, ``</s>`` at 0-2, the
    256 byte tokens at 3-258 (less ``missing_bytes``), then the pieces
    trained on the corpus; ``byte_fallback`` and ``fuse_unk``. ``prepend``
    is Llama 2's and Mistral v0.1's layout (a ``Prepend``/``Replace``
    normalizer, no pre-tokenizer); ``metaspace`` the newer Mistral files'
    (a ``Metaspace`` pre-tokenizer). The decoder is
    ``Sequence[Replace, ByteFallback, Fuse, Strip]`` (or ``Metaspace``).
    Saved as ``LlamaTokenizerFast`` (its ``add_bos_token`` and
    ``add_eos_token`` in ``config``), or as ``PreTrainedTokenizerFast`` with
    a ``TemplateProcessing`` of ``<s> $A``."""
    from tokenizers import AddedToken, Tokenizer, decoders, models, normalizers, pre_tokenizers, processors, trainers
    from transformers import LlamaTokenizerFast, PreTrainedTokenizerFast

    trainer_tok = Tokenizer(models.BPE(unk_token="<unk>"))
    trainer_tok.pre_tokenizer = pre_tokenizers.Metaspace(replacement="▁", prepend_scheme="always", split=True)
    trainer = trainers.BpeTrainer(vocab_size=700, special_tokens=SP_SPECIALS, show_progress=False)
    trainer_tok.train_from_iterator(_training_text(), trainer)
    trained = json.loads(trainer_tok.to_str())["model"]
    vocab = {t: i for i, t in enumerate(SP_SPECIALS)}
    vocab.update({f"<0x{b:02X}>": 3 + b for b in range(256) if b not in missing_bytes})
    for token, i in sorted(trained["vocab"].items(), key=lambda kv: kv[1]):
        if token not in vocab:
            vocab[token] = 259 + i - len(SP_SPECIALS)
    merges = [tuple(m) if isinstance(m, list) else tuple(m.split(" ", 1)) for m in trained["merges"]]
    tok = Tokenizer(models.BPE(vocab=vocab, merges=merges, unk_token="<unk>", byte_fallback=True, fuse_unk=True))
    if layout == "prepend":
        tok.normalizer = normalizers.Sequence([normalizers.Prepend("▁"), normalizers.Replace(" ", "▁")])
    else:
        tok.pre_tokenizer = pre_tokenizers.Metaspace(replacement="▁", prepend_scheme=prepend_scheme, split=split)
    tok.decoder = (decoders.Metaspace(replacement="▁", prepend_scheme=prepend_scheme, split=split)
                   if metaspace_decoder else
                   decoders.Sequence([decoders.Replace("▁", " "), decoders.ByteFallback(), decoders.Fuse(),
                                      decoders.Strip(" ", 1, 0)]))
    tok.post_processor = processors.TemplateProcessing(single="<s> $A", pair="<s> $A <s> $B",
                                                       special_tokens=[("<s>", 1)])
    tok.add_special_tokens([AddedToken(t, special=True, normalized=False) for t in SP_SPECIALS])
    names = dict(bos_token="<s>", eos_token="</s>", unk_token="<unk>")
    if llama_class:
        fast = LlamaTokenizerFast(tokenizer_object=tok, legacy=False, **names, **config)
    else:
        fast = PreTrainedTokenizerFast(tokenizer_object=tok, **names, **config)
    fast.chat_template = (FIXTURES / "chat_template_mistral.jinja").read_text()
    return fast


BUILDERS = {
    "llama3_tokenizer": build_llama3_tokenizer,
    "sp_tokenizer": lambda: build_sp_tokenizer("prepend"),
    "sp_metaspace_tokenizer": lambda: build_sp_tokenizer("metaspace", prepend_scheme="first", split=False),
}


def expected_ids() -> dict:
    """``tokenizer_ids.json``: the fixed chats (each family's messages, the
    tools, the Llama 3 template's date pinned) and prompts, and the ids
    ``AutoTokenizer`` gives for them from each committed family: each
    chat's ids with a generation prompt, and ``encode`` of each prompt."""
    from transformers import AutoTokenizer

    ids = {}
    for name in FAMILIES:
        ref = AutoTokenizer.from_pretrained(str(FIXTURES / name))
        chats = LLAMA3_MESSAGES if name == "llama3_tokenizer" else MISTRAL_MESSAGES
        ids[name] = {
            "chat": {chat: ref.apply_chat_template(messages, add_generation_prompt=True, tokenize=True,
                                                   tools=TOOLS if chat == "tool_call" else None,
                                                   date_string=DATE_STRING)
                     for chat, messages in chats.items()},
            "encode": [ref.encode(prompt) for prompt in ENCODE_PROMPTS],
        }
    return {"messages": {"llama3": LLAMA3_MESSAGES, "mistral": MISTRAL_MESSAGES}, "tools": TOOLS,
            "date_string": DATE_STRING, "prompts": ENCODE_PROMPTS, "ids": ids}


@contextlib.contextmanager
def quiet():
    """The process's stdout and stderr closed off: the library prints a
    warning of 1.8 MB there each time it serializes the Llama 3 vocabulary,
    whose ids have holes below 128,000."""
    sys.stdout.flush()
    sys.stderr.flush()
    saved = [os.dup(1), os.dup(2)]
    with open(os.devnull, "w") as null:
        os.dup2(null.fileno(), 1)
        os.dup2(null.fileno(), 2)
        try:
            yield
        finally:
            for fd, old in zip((1, 2), saved):
                os.dup2(old, fd)
                os.close(old)


def save(fast, path: Path) -> Path:
    path.mkdir(parents=True, exist_ok=True)
    with quiet():
        fast.save_pretrained(str(path))
    return path


def pair_of(path: Path):
    from transformers import AutoTokenizer

    return HFTokenizer(path), AutoTokenizer.from_pretrained(str(path))


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    return request.param, pair_of(FIXTURES / request.param)


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """Each family as its builder saves it here."""
    return {name: save(build(), tmp_path_factory.mktemp(name)) for name, build in BUILDERS.items()}


# layouts beside the committed ones, each against AutoTokenizer
VARIANTS = {
    "metaspace_always_split": dict(layout="metaspace", prepend_scheme="always", split=True),
    "metaspace_never": dict(layout="metaspace", prepend_scheme="never", split=True),
    "metaspace_decoder_first": dict(layout="metaspace", prepend_scheme="first", split=True, metaspace_decoder=True),
    "metaspace_decoder_never": dict(layout="metaspace", prepend_scheme="never", split=False, metaspace_decoder=True),
    "missing_bytes": dict(layout="prepend", missing_bytes=(0xE6, 0x97, 0xF0)),
    "add_eos": dict(layout="prepend", add_bos_token=True, add_eos_token=True),
    "no_bos": dict(layout="metaspace", add_bos_token=False),
    "template_processing": dict(layout="prepend", llama_class=False),
}


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def variant(request, tmp_path_factory):
    path = save(build_sp_tokenizer(**VARIANTS[request.param]), tmp_path_factory.mktemp(request.param))
    return request.param, pair_of(path)


def _check_text(ours, ref, text):
    for specials in (True, False):
        ids = ours.encode(text, add_special_tokens=specials)
        assert ids == ref.encode(text, add_special_tokens=specials), (text, specials)
        for skip in (False, True):
            assert ours.decode(ids, skip_special_tokens=skip) == ref.decode(ids, skip_special_tokens=skip), text


def test_fixture_files_are_what_the_builders_save(built):
    """The committed directories are what the builders save, and
    ``tokenizer_ids.json`` is what ``AutoTokenizer`` gives from them."""
    for name, path in built.items():
        for file in FILES:
            a, b = path / file, FIXTURES / name / file
            if file.endswith(".json"):
                assert json.loads(a.read_text()) == json.loads(b.read_text()), (name, file)
            else:
                assert a.read_text() == b.read_text(), (name, file)
    assert json.loads((FIXTURES / "tokenizer_ids.json").read_text()) == expected_ids()


def test_committed_ids_are_the_ports(family):
    """What phase 30 checks on the card host: the port gives the committed
    ids for the committed chats and prompts."""
    name, (ours, _) = family
    committed = json.loads((FIXTURES / "tokenizer_ids.json").read_text())
    chats = committed["messages"]["llama3" if name == "llama3_tokenizer" else "mistral"]
    for chat, messages in chats.items():
        assert ours.apply_chat_template(messages, add_generation_prompt=True,
                                        tools=committed["tools"] if chat == "tool_call" else None,
                                        date_string=committed["date_string"]) == committed["ids"][name]["chat"][chat]
    assert [ours.encode(p) for p in committed["prompts"]] == committed["ids"][name]["encode"]


def test_llama3_layout(family):
    """Llama 3's specials at their published ids, its vocabulary padded
    between the pieces and 128,000; the SentencePiece files' byte tokens."""
    name, (ours, ref) = family
    if name == "llama3_tokenizer":
        assert (ours.bos_token_id, ours.eos_token_id) == (128000, 128001)
        assert ours.encode("say x")[0] == 128000 and len(ours) == len(ref) < 128000
    else:
        assert (ours.unk_token_id, ours.bos_token_id, ours.eos_token_id) == (0, 1, 2)
        assert ours.token_to_id("<0x00>") == 3 and ours.token_to_id("<0xFF>") == 258


def test_len_and_special_ids(family):
    _, (ours, ref) = family
    assert len(ours) == len(ref)
    for key in ("bos_token", "eos_token", "unk_token", "pad_token"):
        assert getattr(ours, key) == getattr(ref, key), key
        assert getattr(ours, f"{key}_id") == getattr(ref, f"{key}_id"), key


def test_encode_decode_corpus_and_edges(family):
    _, (ours, ref) = family
    for text in _corpus()[:120] + EXTRA_TEXTS:
        _check_text(ours, ref, text)


@settings(max_examples=120, deadline=None)
@given(parts=st.lists(st.one_of(st.text(max_size=24), st.sampled_from(SP_SPECIALS + ["<|begin_of_text|>", "<|eot_id|>"]),
                                st.sampled_from([" ", "  ", "\n", "\t", "\r\n", "▁", "   \n "])), max_size=8))
def test_encode_decode_random_text(parts):
    text = "".join(parts)
    for name in FAMILIES:
        _check_text(*_pairs()[name], text)


@settings(max_examples=80, deadline=None)
@given(ids=st.lists(st.integers(0, 1000), max_size=40), high=st.lists(st.integers(128000, 128260), max_size=3))
def test_decode_arbitrary_ids(ids, high):
    """Byte tokens that split a UTF-8 sequence, specials and ids past the
    vocabulary decode as the library decodes them."""
    for name in FAMILIES:
        ours, ref = _pairs()[name]
        for skip in (False, True):
            assert ours.decode(ids + high, skip_special_tokens=skip) == ref.decode(ids + high, skip_special_tokens=skip)


_PAIRS: dict = {}


def _pairs() -> dict:
    if not _PAIRS:
        _PAIRS.update({name: pair_of(FIXTURES / name) for name in FAMILIES})
    return _PAIRS


def test_variants(variant):
    """Metaspace's prepend schemes and split, the Metaspace decoder, byte
    tokens missing (``<unk>``, fused), ``add_eos_token``, no BOS, and a
    plain ``TemplateProcessing``."""
    _, (ours, ref) = variant
    assert len(ours) == len(ref) and ours.bos_token_id == ref.bos_token_id
    for text in EXTRA_TEXTS + ["日本 and 🙂🙂 then æ and 日x🙂", "a 🙂 b", "🙂🙂"]:
        _check_text(ours, ref, text)


def test_byte_fallback_and_unk(tmp_path):
    """A character outside the vocabulary becomes its byte tokens; ``<unk>``
    appears only where one of its byte tokens is missing, and runs of
    unknowns fuse into one."""
    full = pair_of(FIXTURES / "sp_tokenizer")
    holes = pair_of(save(build_sp_tokenizer("prepend", missing_bytes=(0xF0,)), tmp_path))
    for ours, ref in (full, holes):
        for text in ("🚗", "a🚗🚗b", "日本", "x🚗日", "🚗x🚗", "🚗日🚗", "🚗ẞ", "ẞ🚗ẞ🚗"):
            assert ours.encode(text) == ref.encode(text), text
    ours, _ = full
    assert "🚗" not in ours.vocab and ours.unk_token_id not in ours.encode("🚗日本語")
    ours, _ = holes
    assert ours.encode("🚗🚗", add_special_tokens=False)[-1:] == [ours.unk_token_id]
    assert ours.encode("🚗🚗", add_special_tokens=False).count(ours.unk_token_id) == 1


@pytest.mark.parametrize("add_generation_prompt", [False, True])
@pytest.mark.parametrize("chat", ["one_turn", "system", "tool_call"])
def test_chat_templates(family, chat, add_generation_prompt):
    """The Llama 3 and Mistral style templates: ``bos_token``, the date
    from ``strftime_now`` (and a pinned ``date_string``), the tools loop."""
    name, (ours, ref) = family
    messages = (LLAMA3_MESSAGES if name == "llama3_tokenizer" else MISTRAL_MESSAGES)[chat]
    tools = TOOLS if chat == "tool_call" else None
    for kwargs in ({}, {"date_string": "26 Jul 2024"}):
        for tokenize in (False, True):
            assert ours.apply_chat_template(messages, add_generation_prompt=add_generation_prompt, tokenize=tokenize,
                                            tools=tools, **kwargs) == \
                ref.apply_chat_template(messages, add_generation_prompt=add_generation_prompt, tokenize=tokenize,
                                        tools=tools, **kwargs)


def test_chat_template_raise_exception(family):
    """Roles that do not alternate raise through ``raise_exception`` (the
    Mistral templates); Llama 3's tool-call limit raises the same way."""
    from jinja2.exceptions import TemplateError

    name, (ours, ref) = family
    if name == "llama3_tokenizer":
        messages = [{"role": "user", "content": "x"},
                    {"role": "assistant", "tool_calls": LLAMA3_MESSAGES["tool_call"][1]["tool_calls"] * 2}]
        match = "single tool-calls"
    else:
        messages, match = NOT_ALTERNATING, "must alternate"
    for tok in (ours, ref):
        with pytest.raises(TemplateError, match=match):
            tok.apply_chat_template(messages, tokenize=False)


def test_save_pretrained_round_trip(family, tmp_path):
    name, (ours, _) = family
    ours.save_pretrained(tmp_path)
    again = HFTokenizer(tmp_path)
    for text in EXTRA_TEXTS:
        assert again.encode(text) == ours.encode(text)
    assert len(again) == len(ours) and again.chat_template == ours.chat_template


def test_from_slow_settings_raise(tmp_path):
    """``add_prefix_space`` on ``LlamaTokenizerFast`` asks transformers to
    rebuild from the slow ``tokenizer.model`` (``from_slow``): refused,
    named."""
    for name in FILES:
        shutil.copyfile(FIXTURES / "sp_tokenizer" / name, tmp_path / name)
    config = json.loads((tmp_path / "tokenizer_config.json").read_text())
    config["add_prefix_space"] = False
    (tmp_path / "tokenizer_config.json").write_text(json.dumps(config))
    with pytest.raises(NotImplementedError, match="add_prefix_space"):
        HFTokenizer(tmp_path)


if __name__ == "__main__":
    for name, build in BUILDERS.items():
        shutil.rmtree(FIXTURES / name, ignore_errors=True)
        save(build(), FIXTURES / name)
    ids = expected_ids()
    (FIXTURES / "tokenizer_ids.json").write_text(
        "{\n" + ",\n".join(f"{json.dumps(k)}: {json.dumps(v, ensure_ascii=False)}" for k, v in ids.items())
        + "\n}\n", encoding="utf-8")
