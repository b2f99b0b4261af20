"""Import HuggingFace checkpoints (``config.json`` + safetensors) into the
port's parameter layout.

Port of the JAX package's ``models/hf_loader.py``: the text architectures
(Qwen2/Qwen2.5, Qwen3 with ``qk_norm``, Llama, Mistral) and Qwen2.5-VL,
whose language trunk loads as Qwen2's (with its mrope sections and vision
token ids, from a flat or a nested ``text_config``) and whose vision tower
loads through ``load_hf_vision``. Tensors are read by
``utils.safetensors_io`` (no ``safetensors`` package), one at a time, and
each stacked ``[L, ...]`` parameter is filled on the device layer by layer,
so host memory holds one layer's matrix at a time.
"""

from __future__ import annotations

import json
from pathlib import Path

import torch

from ..utils.safetensors_io import SafetensorsDir
from .transformer import ModelConfig

_SUPPORTED_ARCHS = {
    "Qwen2ForCausalLM": {"attention_bias": True, "qk_norm": False},
    "Qwen3ForCausalLM": {"attention_bias": False, "qk_norm": True},
    "LlamaForCausalLM": {"attention_bias": False, "qk_norm": False},
    "MistralForCausalLM": {"attention_bias": False, "qk_norm": False},
    # a Qwen2 language trunk beside the vision tower (models/vision.py)
    "Qwen2_5_VLForConditionalGeneration": {"attention_bias": True, "qk_norm": False},
}

# (HF name under ``model.layers.{i}.``, port name, stored transposed)
LAYER_TENSORS = (
    ("input_layernorm.weight", "ln1", False),
    ("post_attention_layernorm.weight", "ln2", False),
    ("self_attn.q_proj.weight", "wq", True),
    ("self_attn.k_proj.weight", "wk", True),
    ("self_attn.v_proj.weight", "wv", True),
    ("self_attn.o_proj.weight", "wo", True),
    ("mlp.gate_proj.weight", "wgate", True),
    ("mlp.up_proj.weight", "wup", True),
    ("mlp.down_proj.weight", "wdown", True),
    ("self_attn.q_proj.bias", "bq", False),
    ("self_attn.k_proj.bias", "bk", False),
    ("self_attn.v_proj.bias", "bv", False),
    ("self_attn.q_norm.weight", "q_norm", False),
    ("self_attn.k_norm.weight", "k_norm", False),
)
# (HF name under ``visual.blocks.{i}.``, port name, stored transposed)
VISION_LAYER_TENSORS = (
    ("norm1.weight", "ln1", False),
    ("norm2.weight", "ln2", False),
    ("attn.qkv.weight", "wqkv", True),
    ("attn.qkv.bias", "bqkv", False),
    ("attn.proj.weight", "wo", True),
    ("attn.proj.bias", "bo", False),
    ("mlp.gate_proj.weight", "wgate", True),
    ("mlp.gate_proj.bias", "bgate", False),
    ("mlp.up_proj.weight", "wup", True),
    ("mlp.up_proj.bias", "bup", False),
    ("mlp.down_proj.weight", "wdown", True),
    ("mlp.down_proj.bias", "bdown", False),
)


def load_model_config(model_dir: str | Path, dtype: torch.dtype = torch.bfloat16) -> ModelConfig:
    with open(Path(model_dir) / "config.json") as f:
        hf = json.load(f)
    arch = (hf.get("architectures") or ["?"])[0]
    if arch not in _SUPPORTED_ARCHS:
        raise ValueError(f"Unsupported architecture {arch!r}; supported: {sorted(_SUPPORTED_ARCHS)}")
    flags = _SUPPORTED_ARCHS[arch]
    # a VLM nests its language config under text_config (current
    # transformers) or keeps it flat beside vision_config (the original
    # Qwen2.5-VL releases)
    text = {**hf, **hf.get("text_config", {})}
    rope_scaling = text.get("rope_scaling") or {}
    mrope = rope_scaling.get("mrope_section") if rope_scaling.get("type") in ("mrope", "default") else None
    return ModelConfig(
        vocab_size=text["vocab_size"],
        hidden_size=text["hidden_size"],
        intermediate_size=text["intermediate_size"],
        num_layers=text["num_hidden_layers"],
        num_heads=text["num_attention_heads"],
        num_kv_heads=text.get("num_key_value_heads", text["num_attention_heads"]),
        head_dim=text.get("head_dim"),
        rope_theta=text.get("rope_theta", 10_000.0),
        rms_norm_eps=text.get("rms_norm_eps", 1e-6),
        attention_bias=text.get("attention_bias", flags["attention_bias"]),
        qk_norm=flags["qk_norm"],
        tie_word_embeddings=text.get("tie_word_embeddings", False),
        mrope_section=tuple(mrope) if mrope else None,
        image_token_id=hf.get("image_token_id"),
        vision_start_token_id=hf.get("vision_start_token_id"),
        vision_end_token_id=hf.get("vision_end_token_id"),
        dtype=dtype,
        hf_architecture=arch,
    )


def load_vision_config(model_dir: str | Path, dtype: torch.dtype = torch.bfloat16):
    """The ``VisionConfig`` of a VLM checkpoint's ``config.json``, or None
    for a text model."""
    from .vision import VisionConfig

    with open(Path(model_dir) / "config.json") as f:
        vc = json.load(f).get("vision_config")
    if not vc:
        return None
    return VisionConfig(
        hidden_size=vc["hidden_size"],
        intermediate_size=vc["intermediate_size"],
        num_heads=vc["num_heads"],
        depth=vc["depth"],
        out_hidden_size=vc["out_hidden_size"],
        patch_size=vc.get("patch_size", 14),
        temporal_patch_size=vc.get("temporal_patch_size", 2),
        spatial_merge_size=vc.get("spatial_merge_size", 2),
        window_size=vc.get("window_size", 112),
        fullatt_block_indexes=tuple(vc.get("fullatt_block_indexes", (7, 15, 23, 31))),
        in_channels=vc.get("in_channels", 3),
        tokens_per_second=vc.get("tokens_per_second", 4),
        dtype=dtype,
    )


def _normalize_key(name: str) -> str:
    """The VLM layout variants onto one scheme, as the JAX loader maps them:
    ``model.language_model.*`` to ``model.*``, ``model.visual.*`` to
    ``visual.*``."""
    if name.startswith("model.language_model."):
        return "model." + name[len("model.language_model.") :]
    if name.startswith("model.visual."):
        return name[len("model.") :]
    return name


def load_hf_model(
    model_dir: str | Path, dtype: torch.dtype = torch.bfloat16, device="cuda"
) -> tuple[dict, ModelConfig]:
    """An HF checkpoint directory → (params, ModelConfig), the params in
    ``dtype`` on ``device``. Linear weights are HF's ``[out, in]`` and the
    port's ``[in, out]``."""
    model_dir = Path(model_dir)
    cfg = load_model_config(model_dir, dtype)
    raw = SafetensorsDir(model_dir, _normalize_key)

    def put(t: torch.Tensor) -> torch.Tensor:
        return t.to(device=device, dtype=dtype).contiguous()

    def stacked(hf_name: str, transpose: bool) -> torch.Tensor:
        out = None
        for i in range(cfg.num_layers):
            m = raw.get(f"model.layers.{i}.{hf_name}")
            m = m.T if transpose else m
            if out is None:
                out = torch.empty((cfg.num_layers, *m.shape), dtype=dtype, device=device)
            out[i].copy_(m.to(dtype))
        return out

    present = {
        "bq": cfg.attention_bias, "bk": cfg.attention_bias, "bv": cfg.attention_bias,
        "q_norm": cfg.qk_norm, "k_norm": cfg.qk_norm,
    }
    layers = {
        ours: stacked(hf_name, transpose)
        for hf_name, ours, transpose in LAYER_TENSORS
        if present.get(ours, True)
    }
    params = {"embed": put(raw.get("model.embed_tokens.weight")), "layers": layers,
              "final_norm": put(raw.get("model.norm.weight"))}
    if not cfg.tie_word_embeddings:
        params["lm_head"] = put(raw.get("lm_head.weight").T)
    return params, cfg


def load_hf_vision(model_dir: str | Path, dtype: torch.dtype = torch.bfloat16, device="cuda"):
    """(tower params, ``VisionConfig``) of a Qwen2.5-VL checkpoint, or (None,
    None) for a text model. The layout is the public release's: fused
    ``visual.blocks.{i}.attn.qkv``, a gated MLP with biases, the Conv3d
    patch embed ``[D, C, T, P, P]`` flattened to the ``[patch_dim, D]``
    matmul (the processor flattens each patch in the same (C, T, P, P)
    order), and the RMSNorm merger with its two-layer MLP."""
    model_dir = Path(model_dir)
    vcfg = load_vision_config(model_dir, dtype)
    if vcfg is None:
        return None, None
    raw = SafetensorsDir(model_dir, _normalize_key)

    def put(t: torch.Tensor) -> torch.Tensor:
        return t.to(device=device, dtype=dtype).contiguous()

    def stacked(hf_name: str, transpose: bool) -> torch.Tensor:
        out = None
        for i in range(vcfg.depth):
            m = raw.get(f"visual.blocks.{i}.{hf_name}")
            m = m.T if transpose else m
            if out is None:
                out = torch.empty((vcfg.depth, *m.shape), dtype=dtype, device=device)
            out[i].copy_(m.to(dtype))
        return out

    params = {
        "patch_embed": put(raw.get("visual.patch_embed.proj.weight").reshape(vcfg.hidden_size, -1).T),
        "layers": {ours: stacked(hf_name, transpose) for hf_name, ours, transpose in VISION_LAYER_TENSORS},
        "merger": {
            "ln": put(raw.get("visual.merger.ln_q.weight")),
            "w1": put(raw.get("visual.merger.mlp.0.weight").T),
            "b1": put(raw.get("visual.merger.mlp.0.bias")),
            "w2": put(raw.get("visual.merger.mlp.2.weight").T),
            "b2": put(raw.get("visual.merger.mlp.2.bias")),
        },
    }
    return params, vcfg
