"""LoRA adapters for the port's transformer.

Port of the JAX package's ``train/lora.py``. The adapters are a separate
parameter dict of per-layer factors ``{name}_A`` [L, in, r] and
``{name}_B`` [L, r, out] for the selected projections. The training
forward runs on ``merge_lora``'s W + (alpha / r) A @ B, so autograd reaches
the adapters only; the base weights are frozen and the optimizer covers the
adapters alone. Weight pushes and HF exports send merged weights, so the
engine and HF consumers never see the adapters.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

# the projections an adapter may target, by their parameter names
TARGETS = ("wq", "wk", "wv", "wo", "wgate", "wup", "wdown")


@dataclass(frozen=True)
class LoRAConfig:
    enabled: bool = False
    r: int = 16
    alpha: int = 16
    target_modules: tuple[str, ...] = ("wq", "wv")

    @property
    def scaling(self) -> float:
        return self.alpha / self.r


def lora_config_from(cfg: Any) -> LoRAConfig:
    """The ``lora`` node of a finetune config (disabled when absent)."""
    lora = cfg.get("lora") if hasattr(cfg, "get") else None
    if not lora or not lora.get("enabled", False):
        return LoRAConfig()
    targets = tuple(lora.get("target_modules", []) or ("wq", "wv"))
    for t in targets:
        if t not in TARGETS:
            raise ValueError(f"Unknown LoRA target {t!r}; choose from {TARGETS}")
    return LoRAConfig(enabled=True, r=int(lora.get("r", 16)), alpha=int(lora.get("alpha", 16)), target_modules=targets)


def init_lora_params(generator: torch.Generator, params: dict, lora_cfg: LoRAConfig) -> dict:
    """A ~ N(0, 1/r²) per entry (the JAX package's normal / r) and B = 0, so
    the adapters start as a no-op; in the target weights' dtype and on their
    device. A is drawn from ``generator`` on the generator's device."""
    layers = params["layers"]
    out: dict = {"layers": {}}
    for name in lora_cfg.target_modules:
        w = layers[name]  # [L, in, out]
        L, d_in, d_out = w.shape
        a = torch.randn((L, d_in, lora_cfg.r), generator=generator, device=generator.device) / lora_cfg.r
        out["layers"][f"{name}_A"] = a.to(device=w.device, dtype=w.dtype)
        out["layers"][f"{name}_B"] = torch.zeros((L, lora_cfg.r, d_out), dtype=w.dtype, device=w.device)
    return out


def merge_lora(params: dict, lora_params: dict, lora_cfg: LoRAConfig, local=None) -> dict:
    """``params`` with W + scaling · A @ B for each target: the product and
    the sum in fp32, the result in W's dtype. Differentiable in the
    adapters; the other entries are ``params``' own tensors. Where
    ``params`` hold one tp rank's slices, ``local(name, delta)`` cuts the
    whole product to the rank's slice of ``name``."""
    merged_layers = dict(params["layers"])
    for name in lora_cfg.target_modules:
        a = lora_params["layers"][f"{name}_A"].float()
        b = lora_params["layers"][f"{name}_B"].float()
        w = params["layers"][name]
        delta = torch.bmm(a, b) * lora_cfg.scaling
        if local is not None:
            delta = local(name, delta)
        merged_layers[name] = (w.float() + delta).to(w.dtype)
    return {**params, "layers": merged_layers}
