"""Ragged staged decode attention: a CUDA kernel and its plain version.

Port of the JAX package's Pallas kernel in ``ops/decode_attention.py``
(``_kernel``, reached through ``decode_attention_staged_ragged``). Same
contract as ``ops/attention.decode_attention_staged``: frozen cache + this
window's staged band + the token's own K/V, GQA, softmax over
[cache(:len) | band(:step) | self]. The query is pre-scaled and rounded to
bf16, operands are bf16, scores and sums fp32, and the result is computed in
fp32 and returned in q's dtype.

The kernel (``csrc/decode_attention.cu``) splits each slot's cache rows over
blocks in chunks of ``SPLIT_ROWS`` (``split_plan``), runs Q·Kᵀ and P·V on the
tensor cores, and merges the splits' partials in a second small kernel; its
source note says what bounds it and why it is shaped so.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_NEG_INF = -1e30

# launches of the CUDA kernel (plain-version calls are not counted)
launches = 0

# cache rows per split: csrc/decode_attention.cu's kSplitRows, which the
# kernel checks against the value it is given
SPLIT_ROWS = 256


def split_plan(rows: int) -> int:
    """Blocks per (slot, kv head) for a cap of ``rows`` cache rows per slot:
    T for the slab layout, MAXB * BT for the paged one. Split j owns cache
    rows [j * SPLIT_ROWS, (j + 1) * SPLIT_ROWS); the band-plus-self tile
    belongs to split ``min(len // SPLIT_ROWS, splits - 1)``, and splits past
    it exit at once. Taken from the static shape, never from the lengths, so
    the launch reads nothing back from the card."""
    return max(1, -(-rows // SPLIT_ROWS))


def split_scratch(S: int, K: int, G: int, Dh: int, splits: int, device) -> torch.Tensor | None:
    """fp32 scratch for the splits' partials: per (slot, kv head, split) the
    kernel's record, the running max and sum of 16 heads (G of them used)
    and the unnormalised [G, Dh] accumulator. None when a shape has one
    split (no merge)."""
    if splits == 1:
        return None
    return torch.empty(S * K * splits * (32 + G * Dh), dtype=torch.float32, device=device)


def decode_attention_staged_ragged_plain(
    q, k_new, v_new, k_cache, v_cache, base_lens, k_staged, v_staged, step, scale=None
) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: bf16 operands, fp32 scores
    and sums, bf16 probabilities into P·V, as the TPU kernel computes."""
    S, H, Dh = q.shape
    T, K = k_cache.shape[1], k_cache.shape[2]
    W = k_staged.shape[0]
    G = H // K
    scale = scale if scale is not None else Dh**-0.5
    bf = torch.bfloat16
    qh = (q.float() * scale).to(bf).float().reshape(S, K, G, Dh)
    dev = q.device
    # rows: cache[:T] | band[:W] | self, each [S, R, K, Dh]
    k_all = torch.cat(
        [k_cache.to(bf), k_staged.to(bf).transpose(0, 1), k_new.to(bf)[:, None]], 1
    ).float()
    v_all = torch.cat(
        [v_cache.to(bf), v_staged.to(bf).transpose(0, 1), v_new.to(bf)[:, None]], 1
    ).float()
    r = torch.arange(T + W + 1, device=dev)
    valid = torch.where(
        r[None, :] < T,
        r[None, :] < base_lens[:, None],
        (r[None, :] - T < step) | (r[None, :] == T + W),
    )  # [S, R]
    v_all = v_all.masked_fill(~valid[:, :, None, None], 0.0)
    scores = torch.einsum("skgd,srkd->skgr", qh, k_all)
    scores = scores.masked_fill(~valid[:, None, None, :], _NEG_INF)
    m = scores.amax(-1, keepdim=True)
    p = torch.exp(scores - m).masked_fill(~valid[:, None, None, :], 0.0)
    l = p.sum(-1, keepdim=True)
    out = torch.einsum("skgr,srkd->skgd", p.to(bf).float(), v_all) / l
    return out.reshape(S, H, Dh).to(q.dtype)


def _check(name, t, shape, dtype, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, the kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} is not 16-byte aligned")


def _check_rows(name, t, K, Dh):
    """[A, B, K, Dh] with the (K, Dh) rows contiguous; outer strides free."""
    if t.stride(3) != 1 or t.stride(2) != Dh or t.stride(0) % 8 or t.stride(1) % 8:
        raise ValueError(f"{name} must have contiguous [K, Dh] rows, strides {t.stride()}")


def decode_attention_staged_ragged(
    q: torch.Tensor,  # [S, H, Dh]
    k_new: torch.Tensor,  # [S, K, Dh]
    v_new: torch.Tensor,
    k_cache: torch.Tensor,  # [S, T, K, Dh] — frozen during the window
    v_cache: torch.Tensor,
    base_lens: torch.Tensor,  # [S] int32
    k_staged: torch.Tensor,  # [W, S, K, Dh]
    v_staged: torch.Tensor,
    step: int,
    scale: float | None = None,
) -> torch.Tensor:
    """Drop-in for ``decode_attention_staged``. CPU tensors take the plain
    version; CUDA tensors launch the kernel, which takes int32 lengths, Dh
    32, 64 or 128, G <= 16 and W < 64, and raises on anything else. Like the
    JAX wrapper, it pre-scales a q that is not bf16 in fp32 and rounds it to
    bf16 once, and casts K/V, cache and band to bf16 (a no-op, no copy, for
    the bf16 engine). A length past T reads the T rows, as the plain version
    does.

    The launch runs ``split_plan(T)`` blocks per (slot, kv head); with more
    than one, the splits' partials go to ``split_scratch`` (allocated here,
    so a CUDA-graph capture takes it from its pool) and a second kernel
    merges them in split order. One launch is counted per call."""
    if q.device.type == "cpu":
        return decode_attention_staged_ragged_plain(
            q, k_new, v_new, k_cache, v_cache, base_lens, k_staged, v_staged, step, scale
        )
    global launches
    S, H, Dh = q.shape
    T, K = k_cache.shape[1], k_cache.shape[2]
    W = k_staged.shape[0]
    dev, bf, out_dtype = q.device, torch.bfloat16, q.dtype
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    scale = scale if scale is not None else Dh**-0.5
    if q.dtype != bf:
        q, scale = (q.float() * scale).to(bf), 1.0
    k_new, v_new, k_cache, v_cache, k_staged, v_staged = (
        t.to(bf) for t in (k_new, v_new, k_cache, v_cache, k_staged, v_staged)
    )
    if Dh not in (32, 64, 128) or H % K or H // K > 16 or W >= 64 or not 0 <= step < W:
        raise ValueError(f"unsupported shape H={H} K={K} Dh={Dh} W={W} step={step}")
    _check("q", q, (S, H, Dh), bf, dev)
    _check("k_new", k_new, (S, K, Dh), bf, dev)
    _check("v_new", v_new, (S, K, Dh), bf, dev)
    _check("k_cache", k_cache, (S, T, K, Dh), bf, dev)
    _check("v_cache", v_cache, (S, T, K, Dh), bf, dev)
    _check("base_lens", base_lens, (S,), torch.int32, dev)
    _check("k_staged", k_staged, (W, S, K, Dh), bf, dev)
    _check("v_staged", v_staged, (W, S, K, Dh), bf, dev)
    for name, t in (("q", q), ("k_new", k_new), ("v_new", v_new), ("base_lens", base_lens)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache),
                    ("k_staged", k_staged), ("v_staged", v_staged)):
        _check_rows(name, t, K, Dh)
    if k_cache.stride() != v_cache.stride() or k_staged.stride() != v_staged.stride():
        raise ValueError("K and V must share strides")
    out = torch.empty((S, H, Dh), dtype=torch.float32, device=dev)
    splits = split_plan(T)
    part = split_scratch(S, K, H // K, Dh, splits, dev)
    lib = _build.library("decode_attention")
    err = lib.decode_attention_staged_bf16(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), k_cache.data_ptr(),
        v_cache.data_ptr(), base_lens.data_ptr(), k_staged.data_ptr(),
        v_staged.data_ptr(), out.data_ptr(), None if part is None else part.data_ptr(),
        splits, SPLIT_ROWS, S, H, K, Dh, T, int(step),
        k_cache.stride(0), k_cache.stride(1), k_staged.stride(0), k_staged.stride(1),
        float(scale), torch.cuda.current_stream(dev).cuda_stream,
    )
    if err:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA error {err}")
    launches += 1
    return out.to(out_dtype)


_build.declare(
    "decode_attention",
    "decode_attention_staged_bf16",
    [ctypes.c_void_p] * 10
    + [ctypes.c_int] * 8
    + [ctypes.c_longlong] * 4
    + [ctypes.c_float, ctypes.c_void_p],
)
