"""A byte-level BPE tokenizer read from an HF tokenizer directory, without
``tokenizers`` or ``transformers`` (the H100 host has neither).

It reads ``tokenizer.json``, ``tokenizer_config.json`` and the chat
template (``chat_template.jinja``, where transformers 4.57 writes it, or the
config's ``chat_template``), and gives the ids, text and rendered templates
``AutoTokenizer`` gives for the components it covers:

- added and special tokens, matched in the raw text before anything else
  (leftmost, longest first);
- the normalizer: none or ``NFC``;
- the pre-tokenizer: ``ByteLevel`` with GPT-2's pattern (``use_regex``), or
  ``Sequence[Split(pattern, "Isolated"), ByteLevel(use_regex=false)]`` as
  Qwen2's tokenizers are built;
- the model: ``BPE`` with its merges, applied by rank;
- the decoder: ``ByteLevel``.

Any other component raises and names itself. The patterns' ``\\p{L}``,
``\\p{N}`` and ``\\s`` become ``re`` classes built from ``unicodedata``
categories and the Unicode White_Space list, so they are exact without the
``regex`` package. ``apply_chat_template`` renders with jinja2's
``ImmutableSandboxedEnvironment(trim_blocks=True, lstrip_blocks=True)`` and
the globals and filters transformers adds.
"""

from __future__ import annotations

import json
import re
import shutil
import sys
import unicodedata
from datetime import datetime
from functools import cache
from pathlib import Path
from typing import Sequence

# GPT-2's pre-tokenizer pattern (``ByteLevel`` with ``use_regex``)
GPT2_PATTERN = r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"
# the Unicode White_Space property (Python's ``str.isspace`` also accepts
# U+001C-U+001F, which are not White_Space)
_WHITE_SPACE = "\t\n\x0b\x0c\r \x85\xa0\u1680\u2000-\u200a\u2028\u2029\u202f\u205f\u3000"
_SPECIAL_KEYS = ("bos_token", "eos_token", "unk_token", "sep_token", "pad_token", "cls_token", "mask_token")
_FILES = ("tokenizer.json", "tokenizer_config.json", "chat_template.jinja", "special_tokens_map.json")


@cache
def bytes_to_unicode() -> dict[int, str]:
    """GPT-2's byte → printable character table."""
    keep = [*range(ord("!"), ord("~") + 1), *range(ord("¡"), ord("¬") + 1), *range(ord("®"), ord("ÿ") + 1)]
    table, extra = {}, 0
    for b in range(256):
        if b in keep:
            table[b] = chr(b)
        else:
            table[b] = chr(256 + extra)
            extra += 1
    return table


@cache
def _category_class(prefix: str) -> str:
    """The code points whose general category starts with ``prefix``, as
    the inside of an ``re`` character class."""
    ranges, start = [], None
    for cp in range(sys.maxunicode + 2):
        inside = cp <= sys.maxunicode and unicodedata.category(chr(cp)).startswith(prefix)
        if inside and start is None:
            start = cp
        elif not inside and start is not None:
            ranges.append((start, cp - 1))
            start = None
    return "".join(re.escape(chr(a)) if a == b else f"{re.escape(chr(a))}-{re.escape(chr(b))}" for a, b in ranges)


def translate_pattern(pattern: str) -> re.Pattern:
    """An Oniguruma pattern of an HF pre-tokenizer as a Python ``re``
    pattern: ``\\p{L}``, ``\\p{N}``, ``\\s`` and ``\\S`` become explicit
    classes; anything else passes through."""
    classes = {"L": _category_class("L"), "N": _category_class("N")}
    out, i, in_class = [], 0, False
    while i < len(pattern):
        c = pattern[i]
        if c == "\\":
            nxt = pattern[i + 1]
            if nxt == "p":
                end = pattern.index("}", i)
                name = pattern[i + 3 : end]
                if name not in classes:
                    raise NotImplementedError(f"pattern class \\p{{{name}}} is not supported")
                out.append(classes[name] if in_class else f"[{classes[name]}]")
                i = end + 1
                continue
            if nxt in "sS":
                if in_class and nxt == "S":
                    raise NotImplementedError("\\S inside a character class is not supported")
                ws = _WHITE_SPACE
                out.append(ws if in_class else (f"[{ws}]" if nxt == "s" else f"[^{ws}]"))
                i += 2
                continue
            out.append(pattern[i : i + 2])
            i += 2
            continue
        if c == "[" and not in_class:
            in_class = True
        elif c == "]" and in_class:
            in_class = False
        out.append(c)
        i += 1
    return re.compile("".join(out))


def _isolated_split(pattern: re.Pattern, text: str) -> list[str]:
    """``Split(behavior="Isolated")``: every match and every gap between
    matches is a piece of its own."""
    pieces, pos = [], 0
    for m in pattern.finditer(text):
        if m.start() > pos:
            pieces.append(text[pos : m.start()])
        if m.end() > m.start():
            pieces.append(m.group())
        pos = m.end()
    if pos < len(text):
        pieces.append(text[pos:])
    return pieces


def _token_content(value) -> str | None:
    """A special-token entry of a tokenizer config: a string, or an
    AddedToken dict."""
    if isinstance(value, dict):
        return value.get("content")
    return value


class HFTokenizer:
    """The subset of ``PreTrainedTokenizerFast`` the port's client and
    domains call: ``len``, ``encode``, ``decode``, ``eos_token_id``,
    ``pad_token_id``, ``apply_chat_template`` and ``save_pretrained``."""

    def __init__(self, directory: str | Path):
        self.directory = Path(directory)
        spec = json.loads((self.directory / "tokenizer.json").read_text(encoding="utf-8"))
        config_path = self.directory / "tokenizer_config.json"
        config = json.loads(config_path.read_text(encoding="utf-8")) if config_path.exists() else {}
        special_map_path = self.directory / "special_tokens_map.json"
        if special_map_path.exists():
            config = {**json.loads(special_map_path.read_text(encoding="utf-8")), **config}

        model = spec.get("model") or {}
        if model.get("type") != "BPE":
            raise NotImplementedError(f"tokenizer model {model.get('type')!r} is not supported (BPE only)")
        for key in ("dropout", "continuing_subword_prefix", "end_of_word_suffix", "unk_token"):
            if model.get(key):
                raise NotImplementedError(f"BPE option {key}={model[key]!r} is not supported")
        if model.get("byte_fallback"):
            raise NotImplementedError("BPE option byte_fallback is not supported")
        self.vocab: dict[str, int] = dict(model["vocab"])
        merges = [tuple(m.split(" ", 1)) if isinstance(m, str) else tuple(m) for m in model.get("merges", [])]
        self.ranks = {pair: rank for rank, pair in enumerate(merges)}
        self.ignore_merges = bool(model.get("ignore_merges", False))

        self.added: dict[str, int] = {}
        self.special_ids: set[int] = set()
        for tok in spec.get("added_tokens") or []:
            for key in ("lstrip", "rstrip", "single_word"):
                if tok.get(key):
                    raise NotImplementedError(f"added token {tok['content']!r} with {key} is not supported")
            if tok.get("normalized") and not tok.get("special"):
                raise NotImplementedError(f"added token {tok['content']!r} matched after normalization is not supported")
            self.added[tok["content"]] = tok["id"]
            if tok.get("special"):
                self.special_ids.add(tok["id"])
        self._added_re = (
            re.compile("|".join(re.escape(t) for t in sorted(self.added, key=len, reverse=True)))
            if self.added else None
        )
        self.id_to_token = {i: t for t, i in self.vocab.items()}
        self.id_to_token.update({i: t for t, i in self.added.items()})

        self._normalize = self._normalizer(spec.get("normalizer"))
        self._split_re, self.add_prefix_space = self._pre_tokenizer(
            spec.get("pre_tokenizer"), bool(config.get("add_prefix_space", False)))
        decoder = spec.get("decoder") or {}
        if decoder.get("type") != "ByteLevel":
            raise NotImplementedError(f"decoder {decoder.get('type')!r} is not supported (ByteLevel only)")
        post = spec.get("post_processor")
        if post is not None and post.get("type") != "ByteLevel":
            raise NotImplementedError(f"post-processor {post.get('type')!r} is not supported")
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {c: b for b, c in self.byte_encoder.items()}
        self._bpe_cache: dict[str, list[int]] = {}

        self.special_tokens_map = {k: _token_content(config[k]) for k in _SPECIAL_KEYS if config.get(k)}
        if config.get("additional_special_tokens"):
            self.special_tokens_map["additional_special_tokens"] = [
                _token_content(t) for t in config["additional_special_tokens"]
            ]
        self.eos_token = self.special_tokens_map.get("eos_token")
        self.pad_token = self.special_tokens_map.get("pad_token")
        self.eos_token_id = self.token_to_id(self.eos_token)
        self.pad_token_id = self.token_to_id(self.pad_token)
        self.clean_up_tokenization_spaces = bool(config.get("clean_up_tokenization_spaces", False))
        template_path = self.directory / "chat_template.jinja"
        self.chat_template = (
            template_path.read_text(encoding="utf-8") if template_path.exists() else config.get("chat_template")
        )
        self._template = None

    # -- components ---------------------------------------------------------
    @staticmethod
    def _normalizer(spec):
        if spec is None:
            return None
        if spec.get("type") == "NFC":
            return lambda text: unicodedata.normalize("NFC", text)
        raise NotImplementedError(f"normalizer {spec.get('type')!r} is not supported (NFC or none)")

    @staticmethod
    def _pre_tokenizer(spec, config_prefix_space: bool) -> tuple[re.Pattern | None, bool]:
        """(the split pattern, ByteLevel's add_prefix_space). A top-level
        ByteLevel takes ``add_prefix_space`` from the tokenizer config (false
        when absent), as ``PreTrainedTokenizerFast`` overrides it."""
        if spec is None:
            raise NotImplementedError("a tokenizer without a pre-tokenizer is not supported (ByteLevel only)")
        if spec.get("type") == "ByteLevel":
            pattern = translate_pattern(GPT2_PATTERN) if spec.get("use_regex", True) else None
            return pattern, config_prefix_space
        if spec.get("type") == "Sequence":
            parts = spec.get("pretokenizers") or []
            if (len(parts) == 2 and parts[0].get("type") == "Split" and parts[1].get("type") == "ByteLevel"
                    and not parts[1].get("use_regex", True)):
                split = parts[0]
                if split.get("behavior") != "Isolated" or split.get("invert"):
                    raise NotImplementedError(
                        f"Split behavior {split.get('behavior')!r} invert={split.get('invert')} is not supported")
                pattern = split["pattern"]
                regex = translate_pattern(pattern["Regex"]) if "Regex" in pattern else re.compile(re.escape(pattern["String"]))
                return regex, bool(parts[1].get("add_prefix_space"))
        raise NotImplementedError(f"pre-tokenizer {json.dumps(spec)[:120]} is not supported")

    def token_to_id(self, token: str | None) -> int | None:
        if token is None:
            return None
        return self.added.get(token, self.vocab.get(token))

    def __len__(self) -> int:
        return len({**self.vocab, **self.added})

    # -- encode -------------------------------------------------------------
    def _bpe(self, word: str) -> list[int]:
        """BPE over one byte-mapped pre-token: merge the pair of lowest rank,
        every occurrence left to right, until no pair has a rank."""
        if word in self._bpe_cache:
            return self._bpe_cache[word]
        if self.ignore_merges and word in self.vocab:
            return [self.vocab[word]]
        parts = list(word)
        while len(parts) > 1:
            best = min(zip(parts, parts[1:]), key=lambda pair: self.ranks.get(pair, len(self.ranks)))
            if best not in self.ranks:
                break
            first, second = best
            merged, i = [], 0
            while i < len(parts):
                if i + 1 < len(parts) and parts[i] == first and parts[i + 1] == second:
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(parts[i])
                    i += 1
            parts = merged
        # a symbol outside the vocabulary is dropped, as the library drops it
        # without an unk token
        ids = [self.vocab[p] for p in parts if p in self.vocab]
        self._bpe_cache[word] = ids
        return ids

    def _encode_text(self, text: str) -> list[int]:
        if self._normalize is not None:
            text = self._normalize(text)
        if self.add_prefix_space and not text.startswith(" "):
            text = " " + text
        pieces = _isolated_split(self._split_re, text) if self._split_re is not None else [text]
        ids: list[int] = []
        for piece in pieces:
            ids += self._bpe("".join(self.byte_encoder[b] for b in piece.encode("utf-8")))
        return ids

    def encode(self, text: str, add_special_tokens: bool = True) -> list[int]:
        """Token ids of ``text``. No post-processor this class accepts adds
        tokens, so ``add_special_tokens`` changes nothing."""
        ids: list[int] = []
        pos = 0
        for m in self._added_re.finditer(text) if self._added_re is not None else ():
            if m.start() > pos:
                ids += self._encode_text(text[pos : m.start()])
            ids.append(self.added[m.group()])
            pos = m.end()
        if pos < len(text):
            ids += self._encode_text(text[pos:])
        return ids

    # -- decode -------------------------------------------------------------
    def decode(self, ids: Sequence[int], skip_special_tokens: bool = False) -> str:
        """The ByteLevel decoder over the ids' tokens (ids outside the
        vocabulary are skipped; a token with a character outside the byte
        table contributes its own UTF-8 bytes), then, when the config asks
        for it, transformers' ``clean_up_tokenization``."""
        out = bytearray()
        for i in ids:
            i = int(i)
            token = self.id_to_token.get(i)
            if token is None or (skip_special_tokens and i in self.special_ids):
                continue
            try:
                out += bytes(self.byte_decoder[c] for c in token)
            except KeyError:
                out += token.encode("utf-8")
        text = out.decode("utf-8", errors="replace")
        if self.clean_up_tokenization_spaces:
            for a, b in ((" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","), (" ' ", "'"), (" n't", "n't"),
                         (" 'm", "'m"), (" 's", "'s"), (" 've", "'ve"), (" 're", "'re")):
                text = text.replace(a, b)
        return text

    # -- chat template ------------------------------------------------------
    def _compiled_template(self):
        if self._template is None:
            import jinja2
            import jinja2.ext
            from jinja2.sandbox import ImmutableSandboxedEnvironment

            if self.chat_template is None:
                raise ValueError(f"{self.directory} has no chat template")

            def raise_exception(message):
                raise jinja2.exceptions.TemplateError(message)

            def tojson(x, ensure_ascii=False, indent=None, separators=None, sort_keys=False):
                return json.dumps(x, ensure_ascii=ensure_ascii, indent=indent, separators=separators,
                                  sort_keys=sort_keys)

            env = ImmutableSandboxedEnvironment(trim_blocks=True, lstrip_blocks=True,
                                                extensions=[jinja2.ext.loopcontrols])
            env.filters["tojson"] = tojson
            env.globals["raise_exception"] = raise_exception
            env.globals["strftime_now"] = lambda fmt: datetime.now().strftime(fmt)
            self._template = env.from_string(self.chat_template)
        return self._template

    def apply_chat_template(self, conversation: list[dict], add_generation_prompt: bool = False,
                            tokenize: bool = True, tools: list[dict] | None = None,
                            documents: list[dict] | None = None, **kwargs):
        """The rendered template (transformers' variables: ``messages``,
        ``tools``, ``documents``, ``add_generation_prompt``, the special
        tokens and any extra keyword), or its ids."""
        text = self._compiled_template().render(
            messages=conversation, tools=tools, documents=documents,
            add_generation_prompt=add_generation_prompt, **{**self.special_tokens_map, **kwargs},
        )
        return self.encode(text, add_special_tokens=False) if tokenize else text

    def save_pretrained(self, directory: str | Path) -> None:
        """Copy the files this tokenizer was read from into ``directory``."""
        for name in _FILES:
            if (self.directory / name).exists():
                shutil.copyfile(self.directory / name, Path(directory) / name)
