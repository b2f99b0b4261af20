"""Paged decode attention over a shared KV page pool: a CUDA kernel, its plain
version, and the indexed append that writes new rows through the table.

Port of the JAX package's ``ops/paged_attention.py``: the Pallas kernel
``_build_paged_call`` (reached through ``paged_decode_attention``) and
``paged_append``. Layout:

- pool: ``[NB, BT, K, Dh]`` per layer, shared by all slots;
- block table: ``[S, MAXB]`` int32 physical page ids kept by the host
  (``inference/block_pool.BlockPool``), ``-1`` where a slot holds no page.
  Cache row t of slot s lives in page ``clip(table[s, t // BT], 0, NB - 1)``
  at offset ``t % BT``; rows at or past ``min(lens[s], MAXB * BT)`` are masked.

The attention is that of ``ops/decode_attention.py`` (softmax over
[pages(:len) | band(:step) | self]); only where the cache rows come from
differs. The kernel is a second entry of ``csrc/decode_attention.cu`` that
shares kernel #1's body, its split plan and its merge; its source note says
what bounds it.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .decode_attention import (
    SPLIT_ROWS, _check, _check_rows, decode_attention_staged_ragged_plain, split_plan, split_scratch,
)

# launches of the CUDA kernel (plain-version calls are not counted)
launches = 0


def gather_pages(pool: torch.Tensor, block_table: torch.Tensor) -> torch.Tensor:
    """[..., NB, BT, K, Dh] pool and [S, MAXB] table → the contiguous
    [..., S, MAXB * BT, K, Dh] view of each slot's pages (entries clipped
    into the pool, so a ``-1`` reads page 0)."""
    NB, BT = pool.shape[-4], pool.shape[-3]
    S, MAXB = block_table.shape
    table = block_table.long().clamp(0, NB - 1)
    rows = pool.index_select(pool.dim() - 4, table.reshape(-1))
    return rows.reshape(*pool.shape[:-4], S, MAXB * BT, *pool.shape[-2:])


def paged_decode_attention_plain(
    q, k_new, v_new, k_pool, v_pool, block_table, lens, k_staged, v_staged, step, scale=None
) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: gather each slot's pages
    into a contiguous [S, MAXB * BT, K, Dh] view, then kernel #1's plain
    version over it (bf16 operands, fp32 scores and sums, bf16 P). A length
    past MAXB * BT reads every row of the view, as the kernel's cap does."""
    return decode_attention_staged_ragged_plain(
        q, k_new, v_new, gather_pages(k_pool, block_table), gather_pages(v_pool, block_table),
        lens, k_staged, v_staged, step, scale,
    )


def paged_decode_attention(
    q: torch.Tensor,  # [S, H, Dh]
    k_new: torch.Tensor,  # [S, K, Dh] — this step's K/V
    v_new: torch.Tensor,
    k_pool: torch.Tensor,  # [NB, BT, K, Dh] — one layer's pool, frozen in the window
    v_pool: torch.Tensor,
    block_table: torch.Tensor,  # [S, MAXB] int32 physical page ids
    lens: torch.Tensor,  # [S] int32 — tokens already in the pool per slot
    k_staged: torch.Tensor,  # [W, S, K, Dh] — this window's band
    v_staged: torch.Tensor,
    step: int,
    scale: float | None = None,
) -> torch.Tensor:
    """CPU tensors take the plain version; CUDA tensors launch the kernel,
    which takes int32 lengths and table, Dh 32, 64 or 128, G <= 16 and
    W < 64, and raises on anything else. Like the JAX wrapper, it pre-scales
    a q that is not bf16 in fp32 and rounds it to bf16 once, and casts the
    pools, band and K/V to bf16 (a no-op, no copy, for a bf16 engine).

    The launch runs ``split_plan(MAXB * BT)`` blocks per (slot, kv head),
    the same partition as kernel #1 over the gathered view, so the two agree
    bit for bit; with more than one split, the partials go to
    ``split_scratch`` (allocated here) and a second kernel merges them in
    split order. One launch is counted per call."""
    if q.device.type == "cpu":
        return paged_decode_attention_plain(
            q, k_new, v_new, k_pool, v_pool, block_table, lens, k_staged, v_staged, step, scale
        )
    global launches
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    S, H, Dh = q.shape
    NB, BT, K = k_pool.shape[0], k_pool.shape[1], k_pool.shape[2]
    MAXB = block_table.shape[1]
    W = k_staged.shape[0]
    dev, bf, out_dtype = q.device, torch.bfloat16, q.dtype
    scale = scale if scale is not None else Dh**-0.5
    if q.dtype != bf:
        q, scale = (q.float() * scale).to(bf), 1.0
    k_new, v_new, k_pool, v_pool, k_staged, v_staged = (
        t.to(bf) for t in (k_new, v_new, k_pool, v_pool, k_staged, v_staged)
    )
    if Dh not in (32, 64, 128) or H % K or H // K > 16 or W >= 64 or not 0 <= step < W:
        raise ValueError(f"unsupported shape H={H} K={K} Dh={Dh} W={W} step={step}")
    _check("q", q, (S, H, Dh), bf, dev)
    _check("k_new", k_new, (S, K, Dh), bf, dev)
    _check("v_new", v_new, (S, K, Dh), bf, dev)
    _check("k_pool", k_pool, (NB, BT, K, Dh), bf, dev)
    _check("v_pool", v_pool, (NB, BT, K, Dh), bf, dev)
    _check("block_table", block_table, (S, MAXB), torch.int32, dev)
    _check("lens", lens, (S,), torch.int32, dev)
    _check("k_staged", k_staged, (W, S, K, Dh), bf, dev)
    _check("v_staged", v_staged, (W, S, K, Dh), bf, dev)
    for name, t in (("q", q), ("k_new", k_new), ("v_new", v_new), ("block_table", block_table),
                    ("lens", lens)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool),
                    ("k_staged", k_staged), ("v_staged", v_staged)):
        _check_rows(name, t, K, Dh)
    if k_pool.stride() != v_pool.stride() or k_staged.stride() != v_staged.stride():
        raise ValueError("K and V must share strides")
    out = torch.empty((S, H, Dh), dtype=torch.float32, device=dev)
    splits = split_plan(MAXB * BT)
    part = split_scratch(S, K, H // K, Dh, splits, dev)
    lib = _build.library("decode_attention")
    err = lib.paged_decode_attention_bf16(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), k_pool.data_ptr(),
        v_pool.data_ptr(), block_table.data_ptr(), lens.data_ptr(), k_staged.data_ptr(),
        v_staged.data_ptr(), out.data_ptr(), None if part is None else part.data_ptr(),
        splits, SPLIT_ROWS, S, H, K, Dh, int(step), NB, BT, MAXB,
        k_pool.stride(0), k_pool.stride(1), k_staged.stride(0), k_staged.stride(1),
        float(scale), torch.cuda.current_stream(dev).cuda_stream,
    )
    if err:
        raise RuntimeError(f"paged_decode_attention kernel launch failed: CUDA error {err}")
    launches += 1
    return out.to(out_dtype)


def paged_append(
    pool: torch.Tensor,  # [NB, BT, K, Dh], or [L, NB, BT, K, Dh]; updated in place
    rows: torch.Tensor,  # [S, R, K, Dh], or [L, S, R, K, Dh] — new K or V rows
    block_table: torch.Tensor,  # [S, MAXB]
    lens: torch.Tensor,  # [S] — append position per slot
    count: torch.Tensor | None = None,  # [S] rows actually valid (<= R)
) -> torch.Tensor:
    """Write row r of slot s at position ``lens[s] + r`` through the table,
    in place, and return ``pool``. Rows at or past ``count[s]``, or whose
    page index reaches MAXB, are dropped (JAX scatters them to page NB with
    ``mode="drop"``).

    No host sync: a dropped row is redirected to the target and value of
    the first kept row (or, when no row is kept, to a target's current
    value), so every duplicate write carries the same value and the order
    of the writes cannot matter."""
    NB, BT = pool.shape[-4], pool.shape[-3]
    S, R = rows.shape[-4], rows.shape[-3]
    MAXB = block_table.shape[1]
    dev = pool.device
    pos = lens.long()[:, None] + torch.arange(R, device=dev)[None, :]  # [S, R]
    logical = pos // BT
    keep = logical < MAXB
    if count is not None:
        keep = keep & (torch.arange(R, device=dev)[None, :] < count.to(dev)[:, None])
    physical = torch.gather(block_table.long().clamp(0, NB - 1), 1, logical.clamp(max=MAXB - 1))
    target = (physical * BT + pos % BT).reshape(-1)  # [S * R] into [NB * BT]
    keep = keep.reshape(-1)
    first = keep.to(torch.int8).argmax().view(1)  # the first kept row, or 0
    first_target = target.index_select(0, first)
    flat = pool.view(*pool.shape[:-4], NB * BT, *pool.shape[-2:])
    src = rows.reshape(*rows.shape[:-4], S * R, *rows.shape[-2:]).to(pool.dtype)
    axis = flat.dim() - 3
    fill = torch.where(keep.any(), src.index_select(axis, first), flat.index_select(axis, first_target))
    idx = torch.where(keep, target, first_target)
    flat[..., idx, :, :] = torch.where(keep.reshape(-1, 1, 1), src, fill)
    return pool


_build.declare(
    "decode_attention",
    "paged_decode_attention_bf16",
    [ctypes.c_void_p] * 11
    + [ctypes.c_int] * 10
    + [ctypes.c_longlong] * 4
    + [ctypes.c_float, ctypes.c_void_p],
)
