"""The Qwen2.5-VL vision tower, in PyTorch.

Port of the JAX package's ``models/vision.py``. Parameters keep the JAX
pytree's names and its stacked ``[depth, ...]`` layer layout, so the same
arrays load into either package (``transformer.params_from_numpy``); a
Python loop over layers takes the place of ``lax.scan``.

- Host/device split: the window permutation, the rotary (h, w) indices and
  the segment ids are small integer arrays made once per batch of images on
  the host (numpy, ``vision_meta``); the tower consumes patches already in
  window order.
- Window attention is segment-masked attention: a window layer masks to
  same-window pairs, a full-attention layer (``fullatt_block_indexes``) to
  same-frame pairs, over one dense ``[H, N, N]`` fp32 score tensor, as the
  JAX tower computes it in plain jnp (no Pallas kernel). At Qwen2.5-VL-3B
  width (16 heads) 5,376 patches hold 1.85 GB of scores per layer; a tower
  attention that never forms them is ROADMAP work.
- Patch-count buckets: ``prepare_vision_inputs`` pads the patches to a
  merged-token bucket; pad patches form their own segment (id -1) and their
  merged tokens are never spliced.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .transformer import apply_rope, rms_norm

_NEG_INF = -1e30


@dataclass(frozen=True)
class VisionConfig:
    hidden_size: int
    intermediate_size: int
    num_heads: int
    depth: int
    out_hidden_size: int
    patch_size: int = 14
    temporal_patch_size: int = 2
    spatial_merge_size: int = 2
    window_size: int = 112
    fullatt_block_indexes: tuple[int, ...] = (7, 15, 23, 31)
    in_channels: int = 3
    rope_theta: float = 10_000.0
    rms_norm_eps: float = 1e-6
    tokens_per_second: int = 4
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def patch_dim(self) -> int:
        return self.in_channels * self.temporal_patch_size * self.patch_size**2

    @property
    def merge_unit(self) -> int:
        return self.spatial_merge_size**2


def init_vision_params(generator: torch.Generator, cfg: VisionConfig, device="cuda") -> dict:
    """Random init in the JAX ``init_vision_params`` layout: scaled normal
    matrices, unit norms, zero biases, in ``cfg.dtype`` on ``device``."""
    D, Fi, L = cfg.hidden_size, cfg.intermediate_size, cfg.depth
    U = cfg.merge_unit * D
    dt = cfg.dtype

    def normal(shape, scale):
        x = torch.randn(shape, generator=generator, device=generator.device)
        return (x * scale).to(device=device, dtype=dt)

    def ones(*shape):
        return torch.ones(shape, dtype=dt, device=device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=device)

    return {
        "patch_embed": normal((cfg.patch_dim, D), cfg.patch_dim**-0.5),
        "layers": {
            "ln1": ones(L, D),
            "ln2": ones(L, D),
            "wqkv": normal((L, D, 3 * D), D**-0.5),
            "bqkv": zeros(L, 3 * D),
            "wo": normal((L, D, D), D**-0.5),
            "bo": zeros(L, D),
            "wgate": normal((L, D, Fi), D**-0.5),
            "bgate": zeros(L, Fi),
            "wup": normal((L, D, Fi), D**-0.5),
            "bup": zeros(L, Fi),
            "wdown": normal((L, Fi, D), Fi**-0.5),
            "bdown": zeros(L, D),
        },
        "merger": {
            "ln": ones(D),
            "w1": normal((U, U), U**-0.5),
            "b1": zeros(U),
            "w2": normal((U, cfg.out_hidden_size), U**-0.5),
            "b2": zeros(cfg.out_hidden_size),
        },
    }


# ---------------------------------------------------------------------------
# host-side geometry: window permutation, rotary indices, segment ids
# ---------------------------------------------------------------------------


@dataclass
class VisionMeta:
    """Geometry of a batch of images, in numpy. Patch-indexed arrays are in
    the window-permuted order the tower consumes; ``inv_perm`` maps merged
    tokens back to raster order."""

    perm: np.ndarray  # [n_units] merge units, raster -> window order
    inv_perm: np.ndarray  # [n_units]
    hw: np.ndarray  # [N, 2] (h, w) rotary indices per patch, permuted order
    win_seg: np.ndarray  # [N] window segment id per patch
    full_seg: np.ndarray  # [N] frame segment id per patch
    n_patches: int
    n_tokens: int  # n_patches // merge_unit


def vision_meta(grid_thw: np.ndarray, cfg: VisionConfig) -> VisionMeta:
    """Geometry of the images whose patch grids are the [n, 3] (t, h, w)
    rows of ``grid_thw``, with the semantics of Qwen2.5-VL's
    ``rot_pos_emb``/``get_window_index``: raster patches group into
    spatial_merge_size² units; units tile into window_size // patch_size
    spatial windows per frame, cut at the image's edges."""
    m = cfg.spatial_merge_size
    unit = cfg.merge_unit
    win = cfg.window_size // m // cfg.patch_size  # units per window side

    perms: list[np.ndarray] = []
    hw_list: list[np.ndarray] = []
    win_seg: list[np.ndarray] = []
    full_seg: list[np.ndarray] = []
    unit_base = window_id = frame_id = 0
    for t, h, w in np.asarray(grid_thw).reshape(-1, 3):
        gh, gw = h // m, w // m  # merged-token grid
        # (h, w) per patch in unit-grouped order: units scan (gh, gw),
        # patches inside a unit scan (m, m)
        hpos = np.broadcast_to(np.arange(h).reshape(gh, m, 1, 1), (gh, m, gw, m))
        wpos = np.broadcast_to(np.arange(w).reshape(1, 1, gw, m), (gh, m, gw, m))
        hpos = hpos.transpose(0, 2, 1, 3).reshape(-1)
        wpos = wpos.transpose(0, 2, 1, 3).reshape(-1)
        hw_list.append(np.tile(np.stack([hpos, wpos], axis=-1), (int(t), 1)))
        nwh, nww = -(-gh // win), -(-gw // win)
        unit_index = np.arange(t * gh * gw).reshape(t, gh, gw)
        for ti in range(int(t)):
            for wh in range(nwh):
                for ww in range(nww):
                    block = unit_index[ti, wh * win : (wh + 1) * win, ww * win : (ww + 1) * win].reshape(-1)
                    perms.append(block + unit_base)
                    win_seg.append(np.full(block.size * unit, window_id))
                    window_id += 1
            # full attention spans one temporal frame
            full_seg.append(np.full(gh * gw * unit, frame_id))
            frame_id += 1
        unit_base += int(t) * gh * gw

    perm = np.concatenate(perms)
    hw_raster = np.concatenate(hw_list)
    patch_perm = (perm[:, None] * unit + np.arange(unit)[None, :]).reshape(-1)
    return VisionMeta(
        perm=perm,
        inv_perm=np.argsort(perm),
        hw=hw_raster[patch_perm],
        win_seg=np.concatenate(win_seg),
        full_seg=np.concatenate(full_seg)[patch_perm],
        n_patches=perm.size * unit,
        n_tokens=perm.size,
    )


def permute_patches(patches: np.ndarray, meta: VisionMeta, cfg: VisionConfig) -> np.ndarray:
    """Raster-order patches [N, patch_dim] into window order."""
    unit = cfg.merge_unit
    grouped = patches.reshape(patches.shape[0] // unit, unit, -1)
    return grouped[meta.perm].reshape(patches.shape[0], -1)


def prepare_vision_inputs(
    pixels: np.ndarray,  # [N, patch_dim] raster order (HF pixel_values)
    grid_thw: np.ndarray,  # [n_images, 3]
    cfg: VisionConfig,
    unit_buckets: tuple[int, ...] = (64, 256, 1024, 4096),
) -> dict:
    """The tower's inputs at a bucketed size: window-permuted patches padded
    to the smallest merged-token bucket that holds them (pad patches are
    segment -1, pad tokens are never spliced), with their rotary indices,
    segment ids and the inverse permutation, plus ``n_tokens`` (the real
    merged tokens). The engine's prefill and the trainer share it."""
    grid_thw = np.asarray(grid_thw, np.int64).reshape(-1, 3)
    meta = vision_meta(grid_thw, cfg)
    permuted = permute_patches(np.asarray(pixels, np.float32), meta, cfg)
    unit = cfg.merge_unit
    u_bucket = next((b for b in unit_buckets if b >= meta.n_tokens), meta.n_tokens)
    N_b = u_bucket * unit
    patches_p = np.zeros((N_b, permuted.shape[1]), np.float32)
    patches_p[: meta.n_patches] = permuted
    hw_p = np.zeros((N_b, 2), np.int32)
    hw_p[: meta.n_patches] = meta.hw
    win_p = np.full(N_b, -1, np.int32)
    win_p[: meta.n_patches] = meta.win_seg
    full_p = np.full(N_b, -1, np.int32)
    full_p[: meta.n_patches] = meta.full_seg
    inv_p = np.arange(u_bucket, dtype=np.int32)
    inv_p[: meta.n_tokens] = meta.inv_perm
    return {"patches": patches_p, "hw": hw_p, "win_seg": win_p, "full_seg": full_p, "inv_perm": inv_p,
            "n_tokens": meta.n_tokens}


def vision_inputs_to(vin: dict, device) -> dict:
    """``prepare_vision_inputs``' arrays as tensors on ``device`` (index
    arrays int64), without ``n_tokens``."""
    out = {}
    for name, arr in vin.items():
        if name == "n_tokens":
            continue
        t = torch.from_numpy(np.ascontiguousarray(arr))
        out[name] = (t if name == "patches" else t.long()).to(device)
    return out


# ---------------------------------------------------------------------------
# the tower
# ---------------------------------------------------------------------------


def vision_rope(hw: torch.Tensor, head_dim: int, theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """2D rotary: half the rotary channels carry the h index, half the w
    index. hw [N, 2] -> cos/sin [N, head_dim] in the rotate-half layout."""
    dim = head_dim // 2
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=hw.device)
    inv_freq = 1.0 / (theta ** (exps / dim))
    freqs = torch.cat([hw[:, 0].float()[:, None] * inv_freq, hw[:, 1].float()[:, None] * inv_freq], -1)
    emb = torch.cat([freqs, freqs], -1)
    return torch.cos(emb), torch.sin(emb)


def segment_attention(q, k, v, seg, scale) -> torch.Tensor:
    """Non-causal attention masked to same-segment pairs, scores and softmax
    in fp32 (the JAX tower's ``_segment_attention``). q/k/v [N, H, Dh],
    seg [N] -> [N, H, Dh] in v's dtype."""
    mask = seg[:, None] == seg[None, :]
    scores = torch.einsum("nhd,mhd->hnm", q.float(), k.float()) * scale
    scores = scores.masked_fill_(~mask[None], _NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("hnm,mhd->nhd", probs.float(), v.float()).to(v.dtype)


def _linear(x, w, b):
    return x @ w + b


def vision_forward(
    params: dict,
    cfg: VisionConfig,
    patches: torch.Tensor,  # [N, patch_dim] window-permuted order
    hw: torch.Tensor,  # [N, 2]
    win_seg: torch.Tensor,  # [N]
    full_seg: torch.Tensor,  # [N]
    inv_perm: torch.Tensor,  # [n_units]
    remat: bool = False,
) -> torch.Tensor:
    """Patches -> merged visual tokens [N // merge_unit, out_hidden] in
    raster order, ready to splice into the language model. ``remat``
    recomputes each layer in the backward pass (a trained tower keeps one
    layer's ``[H, N, N]`` scores, not all of them)."""
    D, H, Dh = cfg.hidden_size, cfg.num_heads, cfg.head_dim
    x = (patches.float() @ params["patch_embed"].float()).to(cfg.dtype)
    cos, sin = vision_rope(hw, Dh, cfg.rope_theta)
    full = set(int(i) for i in cfg.fullatt_block_indexes)
    scale = Dh**-0.5

    def layer_fn(h, layer, seg):
        normed = rms_norm(h, layer["ln1"], cfg.rms_norm_eps)
        q, k, v = (t.reshape(-1, H, Dh) for t in _linear(normed, layer["wqkv"], layer["bqkv"]).chunk(3, dim=-1))
        attn = segment_attention(apply_rope(q, cos, sin), apply_rope(k, cos, sin), v, seg, scale)
        h = h + _linear(attn.reshape(-1, D), layer["wo"], layer["bo"])
        normed2 = rms_norm(h, layer["ln2"], cfg.rms_norm_eps)
        mlp = F.silu(_linear(normed2, layer["wgate"], layer["bgate"])) * _linear(normed2, layer["wup"], layer["bup"])
        return h + _linear(mlp, layer["wdown"], layer["bdown"])

    names = list(params["layers"])
    for i, ws in enumerate(zip(*(params["layers"][n].unbind(0) for n in names))):
        layer = dict(zip(names, ws))
        seg = full_seg if i in full else win_seg
        x = checkpoint(layer_fn, x, layer, seg, use_reentrant=False) if remat else layer_fn(x, layer, seg)

    merger = params["merger"]
    x = rms_norm(x, merger["ln"], 1e-6).reshape(-1, cfg.merge_unit * D)
    x = F.gelu(_linear(x, merger["w1"], merger["b1"]), approximate="none")
    x = _linear(x, merger["w2"], merger["b2"])
    return x[inv_perm]


def encode_images(params: dict, cfg: VisionConfig, patches: np.ndarray, grid_thw: np.ndarray) -> torch.Tensor:
    """Geometry, permutation and the tower for raster-order patches
    (HF ``pixel_values``) at their own size, on the device of ``params``."""
    vin = prepare_vision_inputs(patches, grid_thw, cfg, unit_buckets=())
    return vision_forward(params, cfg, **vision_inputs_to(vin, params["patch_embed"].device))
