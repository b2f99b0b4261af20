"""A deterministic byte-level tokenizer with a minimal chat template.

A copy of the JAX package's ``models/toy_tokenizer.py``, so the port's
client runs and is tested without HF tokenizers; ``ToyVisualProcessor`` is
its multimodal processor.

Used by hermetic tests and tiny from-scratch training runs where downloading
a real HF tokenizer is impossible (zero-egress environment). Implements the
``TokenizerLike`` protocol of inference/client.py and enough of the HF
tokenizer surface (eos_token_id, apply_chat_template, decode, encode).

Vocab: ids 0-255 are raw bytes; specials follow.
Template (char-level):
    <|im_start|>role\\n content <|im_end|> per message;
    add_generation_prompt appends "<|im_start|>assistant\\n".
"""

from __future__ import annotations

from typing import Sequence

BYTE_VOCAB = 256
IM_START = 256
IM_END = 257
EOS = 257  # <|im_end|> doubles as EOS, Qwen-style
PAD = 258
IMAGE = 259  # image placeholder (one per merged visual token, Qwen-style)
VOCAB_SIZE = 260  # small headroom


class ToyTokenizer:
    eos_token_id = EOS
    pad_token_id = PAD
    eos_token = "<|im_end|>"
    vocab_size = VOCAB_SIZE

    def encode(self, text: str, add_special_tokens: bool = False) -> list[int]:
        return list(text.encode("utf-8", errors="replace"))

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = False) -> str:
        out: list[str] = []
        byte_run: list[int] = []

        def flush():
            if byte_run:
                out.append(bytes(byte_run).decode("utf-8", errors="replace"))
                byte_run.clear()

        for i in ids:
            i = int(i)
            if 0 <= i < BYTE_VOCAB:
                byte_run.append(i)
            else:
                flush()
                if not skip_special_tokens:
                    out.append(
                        {IM_START: "<|im_start|>", IM_END: "<|im_end|>", PAD: "<|pad|>"}.get(
                            i, f"<|{i}|>"
                        )
                    )
        flush()
        return "".join(out)

    def apply_chat_template(
        self,
        conversation: list[dict],
        add_generation_prompt: bool = False,
        tokenize: bool = True,
        **kwargs,
    ):
        ids: list[int] = []
        for msg in conversation:
            ids.append(IM_START)
            ids.extend(self.encode(f"{msg['role']}\n"))
            ids.extend(self.encode(str(msg.get("content") or "")))
            ids.append(IM_END)
        if add_generation_prompt:
            ids.append(IM_START)
            ids.extend(self.encode("assistant\n"))
        if tokenize:
            return ids
        return self.decode(ids)


class ToyVisualProcessor:
    """Deterministic multimodal processor for hermetic VLM runs and tests,
    with the interface of ``inference.processor.HFVisualProcessor``. An
    image part carries its features directly, ``{"type": "image", "image":
    {"pixel_values": [N, patch_dim], "image_grid_thw": [t, h, w]}}``, so
    token counts are exact. Each image expands to t*(h/m)*(w/m) ``IMAGE``
    placeholder tokens, the Qwen convention."""

    def __init__(self, tokenizer: ToyTokenizer, spatial_merge_size: int = 2):
        self.tokenizer = tokenizer
        self.merge = spatial_merge_size
        self.image_token_id = IMAGE

    def __call__(self, messages: list[dict], tools: list[dict] | None = None):
        import numpy as np

        ids: list[int] = []
        pixels: list = []
        grids: list = []
        for msg in messages:
            ids.append(IM_START)
            ids.extend(self.tokenizer.encode(f"{msg['role']}\n"))
            content = msg.get("content")
            if isinstance(content, list):
                for part in content:
                    if part.get("type") == "text":
                        ids.extend(self.tokenizer.encode(part["text"]))
                    elif part.get("type") == "image":
                        img = part["image"]
                        t, h, w = (int(x) for x in img["image_grid_thw"])
                        ids.extend([IMAGE] * (t * (h // self.merge) * (w // self.merge)))
                        pixels.append(np.asarray(img["pixel_values"], np.float32))
                        grids.append((t, h, w))
                    else:
                        raise ValueError(f"Unknown content part {part.get('type')!r}")
            else:
                ids.extend(self.tokenizer.encode(str(content or "")))
            ids.append(IM_END)
        ids.append(IM_START)
        ids.extend(self.tokenizer.encode("assistant\n"))
        visual = None
        if pixels:
            visual = {"pixel_values": np.concatenate(pixels, axis=0), "image_grid_thw": np.asarray(grids, np.int64)}
        return ids, visual
