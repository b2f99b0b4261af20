"""Checkpoints: the training state for resuming, and an HF-format export.

Port of the JAX package's ``train/checkpoints.py``. Under the run's
``finetune/`` directory:

- ``training_state/``: ``state.pt`` (the trainable tensors by dotted name,
  the optimizer's and the scheduler's ``state_dict``), written by
  ``torch.save`` and read back with ``weights_only=True``, and
  ``metrics.json``. This format is the port's own: the JAX package writes
  an orbax checkpoint of optax state, which neither package reads of the
  other.
- ``current/``: ``model.safetensors`` and ``config.json``, the bytes the JAX
  package's ``export_hf`` writes for the same weights, so either package
  (and any HF consumer) loads the other's export.

Both are written into a ``~tmp`` sibling and moved into place with
``os.replace``; a ``~tmp`` left by an interrupted save is removed by the
next one and never read.
"""

from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Any, Callable

import torch

from ..models.hf_loader import LAYER_TENSORS, VISION_LAYER_TENSORS
from ..models.transformer import ModelConfig
from ..utils.safetensors_io import save_file

STATE_DIR = "training_state"
CURRENT_DIR = "current"


def _fresh_tmp(out_dir: Path, name: str) -> Path:
    tmp = out_dir / (name + "~tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    return tmp


def _move_into_place(tmp: Path, final: Path) -> None:
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)


def save_training_state(
    out_dir: str | Path,
    named_params: list[tuple[str, torch.Tensor]],
    optimizer: torch.optim.Optimizer | dict,
    scheduler: Any,
    metrics: dict[str, Any],
) -> Path:
    """Atomic save of the trainable tensors, the optimizer's (or a given
    optimizer ``state_dict``: a trainer world's, gathered to full tensors)
    and scheduler's state and ``metrics`` under ``out_dir/training_state``."""
    out_dir = Path(out_dir).resolve()
    tmp = _fresh_tmp(out_dir, STATE_DIR)
    torch.save(
        {
            "params": {name: p.detach() for name, p in named_params},
            "optimizer": optimizer if isinstance(optimizer, dict) else optimizer.state_dict(),
            "scheduler": scheduler.state_dict(),
        },
        tmp / "state.pt",
    )
    (tmp / "metrics.json").write_text(json.dumps(metrics))
    final = out_dir / STATE_DIR
    _move_into_place(tmp, final)
    return final


@torch.no_grad()
def load_training_state(
    out_dir: str | Path,
    named_params: list[tuple[str, torch.Tensor]],
    optimizer: torch.optim.Optimizer,
    scheduler: Any,
    piece: Callable[[int, torch.Tensor], torch.Tensor] | None = None,
    optimizer_state: Callable[[dict], dict] | None = None,
) -> dict[str, Any] | None:
    """Restore a saved state into ``named_params`` (copied in place, so the
    optimizer's references stay valid), ``optimizer`` and ``scheduler``;
    returns the saved metrics, or None when there is no saved state. A rank
    of a trainer world reads the full state and keeps its part:
    ``piece(i, full)`` of the ``i``-th tensor, ``optimizer_state(saved)``
    of the optimizer's."""
    path = Path(out_dir).resolve() / STATE_DIR
    if not (path / "state.pt").exists():
        return None
    state = torch.load(path / "state.pt", map_location="cpu", weights_only=True)
    saved = state["params"]
    names = [name for name, _ in named_params]
    if sorted(saved) != sorted(names):
        raise ValueError(f"{path} holds tensors {sorted(saved)}, the trainer has {sorted(names)}")
    for i, (name, p) in enumerate(named_params):
        t = saved[name] if piece is None else piece(i, saved[name])
        if t.shape != p.shape or t.dtype != p.dtype:
            raise ValueError(f"{path}: {name} is {t.dtype}{list(t.shape)}, the trainer's {p.dtype}{list(p.shape)}")
        p.copy_(t)
    optimizer.load_state_dict(state["optimizer"] if optimizer_state is None else optimizer_state(state["optimizer"]))
    scheduler.load_state_dict(state["scheduler"])
    return json.loads((path / "metrics.json").read_text())


def hf_tensors(params: dict, model_cfg: ModelConfig) -> dict[str, torch.Tensor]:
    """The text trunk's tensors under HF names, as views of ``params`` (the
    inverse of ``models.hf_loader.load_hf_model``), and a trained
    ``vision_tower``'s under Qwen2.5-VL's ``visual.*`` names (the inverse of
    ``load_hf_vision``; the patch embed goes flat, ``[D, patch_dim]``, which
    the loader's reshape reads as it reads the Conv3d layout). Other keys
    (``value_head``) are left out."""
    tensors = {"model.embed_tokens.weight": params["embed"], "model.norm.weight": params["final_norm"]}
    if "lm_head" in params:
        tensors["lm_head.weight"] = params["lm_head"].T
    layers = params["layers"]
    for i in range(model_cfg.num_layers):
        for hf_name, ours, transpose in LAYER_TENSORS:
            if ours in layers:
                w = layers[ours][i]
                tensors[f"model.layers.{i}.{hf_name}"] = w.T if transpose else w
    tower = params.get("vision_tower")
    if tower is not None:
        tensors["visual.patch_embed.proj.weight"] = tower["patch_embed"].T
        vlayers = tower["layers"]
        for i in range(vlayers["ln1"].shape[0]):
            for hf_name, ours, transpose in VISION_LAYER_TENSORS:
                w = vlayers[ours][i]
                tensors[f"visual.blocks.{i}.{hf_name}"] = w.T if transpose else w
        merger = tower["merger"]
        tensors["visual.merger.ln_q.weight"] = merger["ln"]
        tensors["visual.merger.mlp.0.weight"] = merger["w1"].T
        tensors["visual.merger.mlp.0.bias"] = merger["b1"]
        tensors["visual.merger.mlp.2.weight"] = merger["w2"].T
        tensors["visual.merger.mlp.2.bias"] = merger["b2"]
    return tensors


def hf_config(model_cfg: ModelConfig, vision_cfg=None) -> dict[str, Any]:
    """``config.json`` as the JAX package's ``export_hf`` writes it; with a
    ``vision_cfg`` (a trained tower's export) its ``vision_config`` and the
    image token id too."""
    arch = model_cfg.hf_architecture or (
        "Qwen2ForCausalLM" if model_cfg.attention_bias
        else ("Qwen3ForCausalLM" if model_cfg.qk_norm else "LlamaForCausalLM")
    )
    config = {
        "architectures": [arch],
        "vocab_size": model_cfg.vocab_size,
        "hidden_size": model_cfg.hidden_size,
        "intermediate_size": model_cfg.intermediate_size,
        "num_hidden_layers": model_cfg.num_layers,
        "num_attention_heads": model_cfg.num_heads,
        "num_key_value_heads": model_cfg.num_kv_heads,
        "head_dim": model_cfg.head_dim_,
        "rope_theta": model_cfg.rope_theta,
        "rms_norm_eps": model_cfg.rms_norm_eps,
        "attention_bias": model_cfg.attention_bias,
        "tie_word_embeddings": model_cfg.tie_word_embeddings,
        "torch_dtype": "bfloat16",
        "model_type": {"Qwen2ForCausalLM": "qwen2", "Qwen3ForCausalLM": "qwen3"}.get(arch, "llama"),
    }
    if vision_cfg is not None:
        config["vision_config"] = {
            "hidden_size": vision_cfg.hidden_size,
            "intermediate_size": vision_cfg.intermediate_size,
            "num_heads": vision_cfg.num_heads,
            "depth": vision_cfg.depth,
            "out_hidden_size": vision_cfg.out_hidden_size,
            "patch_size": vision_cfg.patch_size,
            "temporal_patch_size": vision_cfg.temporal_patch_size,
            "spatial_merge_size": vision_cfg.spatial_merge_size,
            "window_size": vision_cfg.window_size,
            "fullatt_block_indexes": list(vision_cfg.fullatt_block_indexes),
            "in_channels": vision_cfg.in_channels,
            "tokens_per_second": vision_cfg.tokens_per_second,
        }
        if model_cfg.image_token_id is not None:
            config["image_token_id"] = model_cfg.image_token_id
    return config


@torch.no_grad()
def export_hf(out_dir: str | Path, params: dict, model_cfg: ModelConfig, tokenizer: Any | None = None,
              vision_cfg=None) -> Path:
    """Write ``model.safetensors`` and ``config.json`` (and the tokenizer's
    files, when it can save them) to ``out_dir/current`` atomically; returns
    that directory. A trained ``vision_tower`` in ``params`` goes under
    ``visual.*``, and ``vision_cfg`` into ``config.json`` with it."""
    out_dir = Path(out_dir)
    tmp = _fresh_tmp(out_dir, CURRENT_DIR)
    save_file(hf_tensors(params, model_cfg), tmp / "model.safetensors")
    config = hf_config(model_cfg, vision_cfg if "vision_tower" in params else None)
    (tmp / "config.json").write_text(json.dumps(config, indent=2))
    if tokenizer is not None and hasattr(tokenizer, "save_pretrained"):
        tokenizer.save_pretrained(tmp)
    final = out_dir / CURRENT_DIR
    _move_into_place(tmp, final)
    return final
