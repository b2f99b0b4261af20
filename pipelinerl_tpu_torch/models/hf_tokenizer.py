"""The BPE tokenizers of the JAX package's text architectures, read from an
HF tokenizer directory without ``tokenizers`` or ``transformers`` (the H100
host has neither).

It reads ``tokenizer.json``, ``tokenizer_config.json`` and the chat
template (``chat_template.jinja``, where transformers 4.57 writes it, or the
config's ``chat_template``), and gives the ids, text and rendered templates
``AutoTokenizer`` gives for the components it covers:

- added and special tokens, matched in the raw text before anything else
  (leftmost, longest first); each stretch of text between them is
  normalized and pre-tokenized on its own;
- the normalizer: none, ``NFC``, ``Prepend``, ``Replace``, or a
  ``Sequence`` of them (Llama 2 and Mistral v0.1 prepend and replace
  spaces with ``▁``);
- the pre-tokenizer: ``ByteLevel`` with GPT-2's pattern (``use_regex``),
  ``Sequence[Split(pattern, "Isolated"), ByteLevel(use_regex=false)]`` as
  Qwen2's and Llama 3's tokenizers are built, ``Metaspace`` (its
  ``prepend_scheme`` ``first``, ``always`` or ``never``, with or without
  ``split``), or none;
- the model: ``BPE`` with its merges, applied by rank and then position
  (the library's queue), with ``byte_fallback`` (a character outside the
  vocabulary becomes its ``<0xXX>`` byte tokens), ``unk_token`` and
  ``fuse_unk``, and ``ignore_merges``;
- the decoder: ``ByteLevel``, ``Metaspace``, or a ``Sequence`` of
  ``Replace``, ``ByteFallback``, ``Fuse`` and ``Strip``;
- the post-processor: none, ``ByteLevel``, ``TemplateProcessing``, or a
  ``Sequence`` of those (Llama 3's); ``encode`` applies the template's
  ``single`` form unless ``add_special_tokens=False``. Where
  ``tokenizer_config.json`` names ``LlamaTokenizer(Fast)``, the template
  is rebuilt from ``add_bos_token`` and ``add_eos_token`` and the special
  tokens default to ``<s>``, ``</s>`` and ``<unk>``, as transformers'
  ``LlamaTokenizerFast`` does.

Any other component, and any setting transformers could only honour from
a slow ``tokenizer.model``, raises and names itself. The patterns'
``\\p{L}``, ``\\p{N}`` and ``\\s`` become ``re`` classes built from
``unicodedata`` categories and the Unicode White_Space list, so they are
exact without the ``regex`` package. ``apply_chat_template`` renders with
jinja2's ``ImmutableSandboxedEnvironment(trim_blocks=True,
lstrip_blocks=True)`` and the globals and filters transformers adds.
"""

from __future__ import annotations

import heapq
import json
import re
import shutil
import sys
import unicodedata
from datetime import datetime
from functools import cache
from pathlib import Path
from typing import Callable, Sequence

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


def _pattern(spec: dict) -> Callable[[str, str], str]:
    """``replace(text, content)`` for a ``Replace`` normalizer's or
    decoder's pattern, a literal string, every occurrence replaced."""
    if "String" not in spec:
        raise NotImplementedError(f"Replace pattern {spec} is not supported (a String only)")
    literal = spec["String"]
    return lambda text, content: text.replace(literal, content)


def _byte_token(token: str) -> int | None:
    """The byte of a ``<0xXX>`` token as the ``ByteFallback`` decoder reads
    it (six UTF-8 bytes, two hex digits, or a sign and one), else None."""
    if len(token.encode("utf-8")) != 6 or not token.startswith("<0x") or not token.endswith(">"):
        return None
    digits = token[3:5]
    return int(digits, 16) if re.fullmatch(r"\+?[0-9A-Fa-f]+", digits) else None


def _utf8_or_replacements(data: bytearray) -> str:
    """A run of byte tokens: its text if it is valid UTF-8, else one U+FFFD
    per byte (``ByteFallback``)."""
    try:
        return data.decode("utf-8")
    except UnicodeDecodeError:
        return "�" * len(data)


def _byte_fallback(tokens: list[str]) -> list[str]:
    out: list[str] = []
    run = bytearray()
    for token in tokens:
        byte = _byte_token(token)
        if byte is not None:
            run.append(byte)
            continue
        if run:
            out.append(_utf8_or_replacements(run))
            run = bytearray()
        out.append(token)
    if run:
        out.append(_utf8_or_replacements(run))
    return out


def _strip(content: str, start: int, stop: int) -> Callable[[list[str]], list[str]]:
    """``Strip``: up to ``start`` leading and ``stop`` trailing ``content``
    characters off each token."""

    def apply(tokens: list[str]) -> list[str]:
        out = []
        for token in tokens:
            lo = 0
            while lo < min(start, len(token)) and token[lo] == content:
                lo += 1
            hi = len(token)
            while len(token) - hi < stop and hi > lo and token[hi - 1] == content:
                hi -= 1
            out.append(token[lo:hi])
        return out

    return apply


# LlamaTokenizerFast's special tokens where the config names none
_LLAMA_CLASSES = ("LlamaTokenizer", "LlamaTokenizerFast")
_LLAMA_DEFAULTS = {"bos_token": "<s>", "eos_token": "</s>", "unk_token": "<unk>"}


class HFTokenizer:
    """The subset of ``PreTrainedTokenizerFast`` the port's client and
    domains call: ``len``, ``encode``, ``decode``, the special tokens and
    their ids, ``apply_chat_template`` and ``save_pretrained``."""

    def __init__(self, directory: str | Path):
        self.directory = Path(directory)
        spec = json.loads((self.directory / "tokenizer.json").read_text(encoding="utf-8"))
        config_path = self.directory / "tokenizer_config.json"
        config = json.loads(config_path.read_text(encoding="utf-8")) if config_path.exists() else {}
        special_map_path = self.directory / "special_tokens_map.json"
        if special_map_path.exists():
            config = {**json.loads(special_map_path.read_text(encoding="utf-8")), **config}
        llama = config.get("tokenizer_class") in _LLAMA_CLASSES
        if llama and (config.get("add_prefix_space") is not None or config.get("from_slow")):
            raise NotImplementedError(
                f"{config['tokenizer_class']} with add_prefix_space={config.get('add_prefix_space')!r} or from_slow "
                "rebuilds the tokenizer from the slow tokenizer.model (from_slow), which is not supported")

        model = spec.get("model") or {}
        if model.get("type") != "BPE":
            raise NotImplementedError(f"tokenizer model {model.get('type')!r} is not supported (BPE only)")
        for key in ("dropout", "continuing_subword_prefix", "end_of_word_suffix"):
            if model.get(key):
                raise NotImplementedError(f"BPE option {key}={model[key]!r} is not supported")
        self.vocab: dict[str, int] = dict(model["vocab"])
        merges = [tuple(m.split(" ", 1)) if isinstance(m, str) else tuple(m) for m in model.get("merges", [])]
        # (left id, right id) → (rank, merged id), as the library keys its merges
        self.ranks: dict[tuple[int, int], tuple[int, int]] = {}
        for rank, (a, b) in enumerate(merges):
            if a not in self.vocab or b not in self.vocab or a + b not in self.vocab:
                raise ValueError(f"merge {a!r} {b!r} names a token outside the vocabulary")
            self.ranks.setdefault((self.vocab[a], self.vocab[b]), (rank, self.vocab[a + b]))
        self.ignore_merges = bool(model.get("ignore_merges", False))
        self.byte_fallback = bool(model.get("byte_fallback", False))
        self.fuse_unk = bool(model.get("fuse_unk", False))
        self._unk_id = None
        if model.get("unk_token") is not None:
            if model["unk_token"] not in self.vocab:
                raise ValueError(f"BPE unk_token {model['unk_token']!r} is not in the vocabulary")
            self._unk_id = self.vocab[model["unk_token"]]

        self._normalize = self._normalizer(spec.get("normalizer"))
        self.added: dict[str, int] = {}
        self.special_ids: set[int] = set()
        for tok in spec.get("added_tokens") or []:
            for key in ("lstrip", "rstrip", "single_word"):
                if tok.get(key):
                    raise NotImplementedError(f"added token {tok['content']!r} with {key} is not supported")
            if tok.get("normalized") and (not tok.get("special") or self._normalize is not None):
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

        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {c: b for b, c in self.byte_encoder.items()}
        self._pre_tokenize = self._pre_tokenizer(spec.get("pre_tokenizer"), bool(config.get("add_prefix_space", False)))
        self._decode_chain = self._decoder(spec.get("decoder"))
        self._bpe_cache: dict[str, list[int]] = {}

        self.special_tokens_map = {k: _token_content(config[k]) for k in _SPECIAL_KEYS if config.get(k)}
        if llama:
            self.special_tokens_map = {**_LLAMA_DEFAULTS, **self.special_tokens_map}
        if config.get("additional_special_tokens"):
            self.special_tokens_map["additional_special_tokens"] = [
                _token_content(t) for t in config["additional_special_tokens"]
            ]
        for key, token in self.special_tokens_map.items():
            for t in token if isinstance(token, list) else [token]:
                if self.token_to_id(t) is None:
                    raise NotImplementedError(f"{key} {t!r} is in neither the vocabulary nor the added tokens "
                                              "(transformers would add it)")
        self.bos_token = self.special_tokens_map.get("bos_token")
        self.eos_token = self.special_tokens_map.get("eos_token")
        self.unk_token = self.special_tokens_map.get("unk_token")
        self.pad_token = self.special_tokens_map.get("pad_token")
        self.bos_token_id = self.token_to_id(self.bos_token)
        self.eos_token_id = self.token_to_id(self.eos_token)
        self.unk_token_id = self.token_to_id(self.unk_token)
        self.pad_token_id = self.token_to_id(self.pad_token)
        if llama:
            # LlamaTokenizerFast.update_post_processor
            self._template = ([self.bos_token_id] if config.get("add_bos_token", True) else [],
                              [self.eos_token_id] if config.get("add_eos_token", False) else [])
        else:
            self._template = self._post_processor(spec.get("post_processor"))
        self.clean_up_tokenization_spaces = bool(config.get("clean_up_tokenization_spaces", False))
        template_path = self.directory / "chat_template.jinja"
        self.chat_template = (
            template_path.read_text(encoding="utf-8") if template_path.exists() else config.get("chat_template")
        )
        self._jinja = None

    # -- components ---------------------------------------------------------
    @classmethod
    def _normalizer(cls, spec) -> Callable[[str], str] | None:
        if spec is None:
            return None
        kind = spec.get("type")
        if kind == "NFC":
            return lambda text: unicodedata.normalize("NFC", text)
        if kind == "Prepend":
            prefix = spec["prepend"]
            return lambda text: prefix + text if text else text
        if kind == "Replace":
            replace, content = _pattern(spec["pattern"]), spec["content"]
            return lambda text: replace(text, content)
        if kind == "Sequence":
            steps = [cls._normalizer(s) for s in spec.get("normalizers") or []]

            def chain(text: str) -> str:
                for step in steps:
                    text = step(text)
                return text

            return chain
        raise NotImplementedError(f"normalizer {kind!r} is not supported (NFC, Prepend, Replace, a Sequence or none)")

    def _pre_tokenizer(self, spec, config_prefix_space: bool) -> Callable[[str, bool], list[str]]:
        """``words(text, first)``: the pre-tokens of one stretch of text
        (``first`` when it starts the input), in the model's alphabet. A
        top-level ByteLevel takes ``add_prefix_space`` from the tokenizer
        config (false when absent), as ``PreTrainedTokenizerFast``
        overrides it."""
        if spec is None:
            return lambda text, first: [text]
        kind = spec.get("type")
        if kind == "ByteLevel":
            pattern = translate_pattern(GPT2_PATTERN) if spec.get("use_regex", True) else None
            return self._byte_level(pattern, config_prefix_space)
        if kind == "Sequence":
            parts = spec.get("pretokenizers") or []
            if (len(parts) == 2 and parts[0].get("type") == "Split" and parts[1].get("type") == "ByteLevel"
                    and not parts[1].get("use_regex", True)):
                split = parts[0]
                if split.get("behavior") != "Isolated" or split.get("invert"):
                    raise NotImplementedError(
                        f"Split behavior {split.get('behavior')!r} invert={split.get('invert')} is not supported")
                pattern = split["pattern"]
                regex = translate_pattern(pattern["Regex"]) if "Regex" in pattern else re.compile(re.escape(pattern["String"]))
                return self._byte_level(regex, bool(parts[1].get("add_prefix_space")))
        if kind == "Metaspace":
            rep = spec.get("replacement", "▁")
            scheme = spec.get("prepend_scheme") or ("always" if spec.get("add_prefix_space", True) else "never")
            if scheme not in ("first", "always", "never"):
                raise NotImplementedError(f"Metaspace prepend_scheme {scheme!r} is not supported")
            split = bool(spec.get("split", True))

            def metaspace(text: str, first: bool) -> list[str]:
                text = text.replace(" ", rep)
                if (scheme == "always" or (scheme == "first" and first)) and not text.startswith(rep):
                    text = rep + text
                if not split:
                    return [text]
                # each replacement starts a word (MergedWithNext)
                cuts = [i for i, c in enumerate(text) if c == rep and i > 0]
                return [text[a:b] for a, b in zip([0, *cuts], [*cuts, len(text)])]

            return metaspace
        raise NotImplementedError(f"pre-tokenizer {json.dumps(spec)[:120]} is not supported")

    def _byte_level(self, pattern: re.Pattern | None, prefix_space: bool) -> Callable[[str, bool], list[str]]:
        def words(text: str, first: bool) -> list[str]:
            if prefix_space and not text.startswith(" "):
                text = " " + text
            pieces = _isolated_split(pattern, text) if pattern is not None else [text]
            return ["".join(self.byte_encoder[b] for b in piece.encode("utf-8")) for piece in pieces]

        return words

    def _decoder(self, spec) -> Callable[[list[str]], list[str]]:
        kind = (spec or {}).get("type")
        if kind == "ByteLevel":
            return lambda tokens: [self._byte_level_text(tokens)]
        if kind == "Metaspace":
            rep = spec.get("replacement", "▁")
            scheme = spec.get("prepend_scheme") or ("always" if spec.get("add_prefix_space", True) else "never")
            # the first token loses every replacement character, the others
            # turn each into a space
            return lambda tokens: [t.replace(rep, "" if i == 0 and scheme != "never" else " ")
                                   for i, t in enumerate(tokens)]
        if kind == "Replace":
            replace, content = _pattern(spec["pattern"]), spec["content"]
            return lambda tokens: [replace(t, content) for t in tokens]
        if kind == "ByteFallback":
            return _byte_fallback
        if kind == "Fuse":
            return lambda tokens: ["".join(tokens)]
        if kind == "Strip":
            return _strip(spec["content"], int(spec.get("start", 0)), int(spec.get("stop", 0)))
        if kind == "Sequence":
            steps = [self._decoder(s) for s in spec.get("decoders") or []]

            def chain(tokens: list[str]) -> list[str]:
                for step in steps:
                    tokens = step(tokens)
                return tokens

            return chain
        raise NotImplementedError(f"decoder {kind!r} is not supported (ByteLevel, Metaspace, or a Sequence of "
                                  "Replace, ByteFallback, Fuse and Strip)")

    @staticmethod
    def _post_processor(spec) -> tuple[list[int], list[int]]:
        """The ids the post-processor's single template puts before and
        after the text's."""
        kind = (spec or {}).get("type")
        if spec is None or kind == "ByteLevel":
            return [], []
        if kind == "Sequence":
            templates = [HFTokenizer._post_processor(p) for p in spec.get("processors") or []]
            templates = [t for t in templates if t != ([], [])]
            if len(templates) > 1:
                raise NotImplementedError("a post-processor Sequence with more than one template is not supported")
            return templates[0] if templates else ([], [])
        if kind == "TemplateProcessing":
            before, after, seen = [], [], False
            for piece in spec["single"]:
                if "Sequence" in piece:
                    if piece["Sequence"]["id"] != "A" or seen:
                        raise NotImplementedError(f"template piece {piece} is not supported")
                    seen = True
                else:
                    (after if seen else before).extend(spec["special_tokens"][piece["SpecialToken"]["id"]]["ids"])
            return before, after
        raise NotImplementedError(f"post-processor {kind!r} is not supported (TemplateProcessing, ByteLevel or "
                                  "a Sequence of them)")

    def token_to_id(self, token: str | None) -> int | None:
        if token is None:
            return None
        return self.added.get(token, self.vocab.get(token))

    def __len__(self) -> int:
        return len({**self.vocab, **self.added})

    # -- encode -------------------------------------------------------------
    def _symbols(self, word: str) -> list[int]:
        """The word's characters as ids, as the library's BPE reads them: a
        character outside the vocabulary becomes its byte tokens
        (``byte_fallback``, when all exist; a pending unknown stays pending
        past them), else the unk id, runs of which fuse under
        ``fuse_unk``; without an unk token it is dropped."""
        ids: list[int] = []
        unk = False
        for ch in word:
            i = self.vocab.get(ch)
            if i is not None:
                if unk:
                    ids.append(self._unk_id)
                    unk = False
                ids.append(i)
                continue
            if self.byte_fallback:
                byte_ids = [self.vocab.get(f"<0x{b:02X}>") for b in ch.encode("utf-8")]
                if None not in byte_ids:
                    ids += byte_ids
                    continue
            if self._unk_id is not None:
                if unk and not self.fuse_unk:
                    ids.append(self._unk_id)
                unk = True
        if unk:
            ids.append(self._unk_id)
        return ids

    def _merge_all(self, ids: list[int]) -> list[int]:
        """Apply the merges as the library's ``Word::merge_all`` does: a
        queue ordered by rank, then position; an entry whose pair has
        changed since it was queued is dropped."""
        n = len(ids)
        if n < 2:
            return ids
        merges = self.ranks
        sym = list(ids)
        nxt = [*range(1, n), -1]
        prv = list(range(-1, n - 1))
        alive = [True] * n
        queue = [(m[0], i, m[1]) for i in range(n - 1) if (m := merges.get((sym[i], sym[i + 1])))]
        heapq.heapify(queue)
        while queue:
            _, pos, new = heapq.heappop(queue)
            right = nxt[pos]
            if not alive[pos] or right < 0:
                continue
            m = merges.get((sym[pos], sym[right]))
            if m is None or m[1] != new:
                continue
            sym[pos] = new
            alive[right] = False
            nxt[pos] = nxt[right]
            if nxt[pos] >= 0:
                prv[nxt[pos]] = pos
            if prv[pos] >= 0 and (m := merges.get((sym[prv[pos]], new))):
                heapq.heappush(queue, (m[0], prv[pos], m[1]))
            if nxt[pos] >= 0 and (m := merges.get((new, sym[nxt[pos]]))):
                heapq.heappush(queue, (m[0], pos, m[1]))
        return [s for s, a in zip(sym, alive) if a]

    def _bpe(self, word: str) -> list[int]:
        ids = self._bpe_cache.get(word)
        if ids is None:
            if self.ignore_merges and word in self.vocab:
                ids = [self.vocab[word]]
            else:
                ids = self._merge_all(self._symbols(word))
            if len(word) <= 256 and len(self._bpe_cache) < 100_000:
                self._bpe_cache[word] = ids
        return ids

    def _encode_text(self, text: str, first: bool) -> list[int]:
        if self._normalize is not None:
            text = self._normalize(text)
        ids: list[int] = []
        for word in self._pre_tokenize(text, first):
            ids += self._bpe(word)
        return ids

    def encode(self, text: str, add_special_tokens: bool = True) -> list[int]:
        """Token ids of ``text``, inside the post-processor's template
        unless ``add_special_tokens`` is false."""
        ids: list[int] = []
        pos = 0
        for m in self._added_re.finditer(text) if self._added_re is not None else ():
            if m.start() > pos:
                ids += self._encode_text(text[pos : m.start()], pos == 0)
            ids.append(self.added[m.group()])
            pos = m.end()
        if pos < len(text):
            ids += self._encode_text(text[pos:], pos == 0)
        if add_special_tokens:
            before, after = self._template
            ids = [*before, *ids, *after]
        return ids

    # -- decode -------------------------------------------------------------
    def _byte_level_text(self, tokens: list[str]) -> str:
        """The ByteLevel decoder: a token with a character outside the byte
        table contributes its own UTF-8 bytes; invalid UTF-8 is replaced."""
        out = bytearray()
        for token in tokens:
            try:
                out += bytes(self.byte_decoder[c] for c in token)
            except KeyError:
                out += token.encode("utf-8")
        return out.decode("utf-8", errors="replace")

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = False) -> str:
        """The decoder over the ids' tokens (ids outside the vocabulary are
        skipped), then, when the config asks for it, transformers'
        ``clean_up_tokenization``."""
        tokens = []
        for i in ids:
            i = int(i)
            token = self.id_to_token.get(i)
            if token is not None and not (skip_special_tokens and i in self.special_ids):
                tokens.append(token)
        text = "".join(self._decode_chain(tokens))
        if self.clean_up_tokenization_spaces:
            for a, b in ((" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","), (" ' ", "'"), (" n't", "n't"),
                         (" 'm", "'m"), (" 's", "'s"), (" 've", "'ve"), (" 're", "'re")):
                text = text.replace(a, b)
        return text

    # -- chat template ------------------------------------------------------
    def _compiled_template(self):
        if self._jinja is None:
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
            self._jinja = env.from_string(self.chat_template)
        return self._jinja

    def apply_chat_template(self, conversation: list[dict], add_generation_prompt: bool = False,
                            tokenize: bool = True, tools: list[dict] | None = None,
                            documents: list[dict] | None = None, **kwargs):
        """The rendered template (transformers' variables: ``messages``,
        ``tools``, ``documents``, ``add_generation_prompt``, the special
        tokens and any extra keyword), or its ids (no post-processor
        template: the chat template places its own special tokens)."""
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
