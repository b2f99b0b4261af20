"""GQA-folded packed causal flash attention, forward and backward: CUDA
kernels, their plain versions and the autograd function over them.

Port of the JAX package's Pallas kernels in ``ops/gqa_attention.py``
(``_fwd_kernel`` via ``_fwd_call``; ``_bwd_dq_kernel`` and
``_bwd_dkv_kernel`` via ``_bwd_call``; the custom VJP of
``mha_packed_gqa``). A query at flat index i of its row (global index
``q_offset + i``) sees key j iff ``q_offset + i >= j`` and the two share a
segment id. The forward gives ``out`` [B, Lq, H, Dh] in q's dtype and
``lse`` [B, Lq, K, G] in fp32; a row that sees no key gets out = 0,
lse = -1e30. The backward recomputes P from (q, k, lse), takes
``delta = rowsum(dO * O)`` in fp32 as the JAX wrapper does, and gives dq,
dk, dv in the inputs' dtypes.

The kernels (``csrc/gqa_attention_fwd.cu``, ``csrc/gqa_attention_bwd.cu``)
fold the G = H/K query heads of a kv head into the rows, walk a tile
schedule (``csrc/gqa_tile_schedule.cuh``; ``bwd_tile_spans_plain`` is its
plain version, whose dq half the forward walks too), and mask ragged edges
themselves, so every length runs on them. The forward splits a q tile's key
span over the blocks of a cluster on short grids (``fwd_splits``), the
dk/dv kernel a key tile's q span (``dkv_splits``), both by ``rank_share``.
``mha_packed_gqa`` is differentiable: CPU tensors take the plain forward and
backward, CUDA tensors the kernels or raise.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_NEG_INF = -1e30

# launches of each CUDA kernel (plain-version calls are not counted)
launches = 0  # forward
dq_launches = 0
dkv_launches = 0

# the kernels' tiles (csrc/gqa_tile_schedule.cuh): the forward and dq take
# 64 folded q rows per block and 64 keys per tile, dk/dv 64 keys per block
# and dkv_q_rows(Dh) folded q rows per tile
TILE = 64
# blocks per tile at most (one cluster): the portable thread-block cluster
# size (the kernels' kMaxSplits)
MAX_SPLITS = 8
# dk/dv blocks a launch aims at: about two resident blocks on each of an
# H100's 132 SMs, twice over
DKV_TARGET_BLOCKS = 512
# an H100 SXM's SMs
SM_COUNT = 132
# forward blocks an SM holds at once, by Dh: the minimum that the kernel's
# __launch_bounds__ asks for (gqa_attention_fwd.cu); chip_smoke.py holds
# both numbers against what the card reports
FWD_BLOCKS_PER_SM = {64: 3, 128: 2}
# key tiles a forward rank keeps at least: below it a split costs more in
# its merge than it saves in the walk (ops/sweep_gqa_attention_fwd.py)
FWD_MIN_TILES = 4


def dkv_q_rows(Dh: int) -> int:
    """Folded q rows per dk/dv tile: 32 at Dh 128, so that kernel's K/V
    fragments and dk/dv sums fit the registers."""
    return 64 if Dh == 64 else 32


def dkv_splits(B: int, Lq: int, Lkv: int, K: int, G: int, Dh: int) -> int:
    """Blocks (one cluster) per key tile of the dk/dv kernel, from the
    static shape alone, so the launch reads nothing back from the card:
    enough to bring the grid to ``DKV_TARGET_BLOCKS``, at most
    ``MAX_SPLITS`` and at most one per q tile."""
    base = -(-Lkv // TILE) * B * K
    n_qt = -(-(Lq * G) // dkv_q_rows(Dh))
    return max(1, min(MAX_SPLITS, n_qt, -(-DKV_TARGET_BLOCKS // base)))


def fwd_splits(B: int, Lq: int, Lkv: int, K: int, G: int, Dh: int) -> int:
    """Blocks (one cluster) per q tile of the forward kernel, from the
    static shape alone: as many as keep the grid within one wave and each
    rank at ``FWD_MIN_TILES`` of a q tile's mean key span, at most
    ``MAX_SPLITS``. The span counts the queries as the row's last Lq
    positions (prefill, extend tails): ceil((Lkv - Lq / 2) / 64) tiles. The
    wave counts 7/8 of the resident blocks (``FWD_BLOCKS_PER_SM`` on each
    of ``SM_COUNT`` SMs): a cluster's blocks share one GPC, so clusters do
    not fill every slot (on an H100 the sweep read S 7 at 392 of 396
    blocks half as fast as S 6 at 336). 1 at the training row, whose grid fills the card,
    and wherever the keys are few; more on a short grid over a long
    prefix."""
    base = -(-(Lq * G) // TILE) * B * K
    wave = FWD_BLOCKS_PER_SM[Dh] * SM_COUNT * 7 // 8
    span = -(-(Lkv - Lq // 2) // TILE)
    return max(1, min(MAX_SPLITS, wave // base, span // FWD_MIN_TILES))


def rank_share(first: int, last: int, splits: int, rank: int) -> tuple[int, int]:
    """The tiles [begin, end) that block ``rank`` of a cluster of ``splits``
    walks, of the span [first, last] (empty when last < first): a key tile's
    q span in dk/dv, a q tile's key span in the forward."""
    n = max(0, last - first + 1)
    return first + rank * n // splits, first + (rank + 1) * n // splits


def _first_last(cand: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """First and last index along the last axis where ``cand`` holds; -1 as
    the last where it never does."""
    idx = torch.arange(cand.shape[-1], device=cand.device)
    first = torch.where(cand, idx, cand.shape[-1]).amin(-1)
    last = torch.where(cand, idx, -1).amax(-1)
    return first, last


def bwd_tile_spans_plain(q_seg, kv_seg, q_offset: int, G: int, Dh: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The backward kernels' tile schedule in plain PyTorch: (dq_spans
    [B, ceil(Lq G / 64), 2], dkv_spans [B, ceil(Lkv / 64), 2]) int32, each
    row an inclusive span [first, last], [0, -1] when empty.

    dq's q tile t (folded rows [64 t, 64 t + 63], positions [r0 // G,
    r_end // G]) walks the key tiles holding the first and last key j <=
    q_offset + its last position whose id lies in the positions' [min, max]
    ids. dk/dv's key tile (keys [64 j, 64 j + 63]) walks the q tiles of
    ``dkv_q_rows(Dh)`` rows holding the first and last position i >= 64 j -
    q_offset whose id lies in the keys' [min, max]. Any visible pair of
    ``_mask`` lies in both spans; the kernels test each tile inside. The
    forward kernel's q tile is dq's, and dq_spans is its schedule too."""
    B, Lq = q_seg.shape
    Lkv = kv_seg.shape[1]
    QR = dkv_q_rows(Dh)
    dev = q_seg.device
    qs, ks = q_seg.long(), kv_seg.long()
    big = torch.iinfo(torch.int64).max
    pos, key = torch.arange(Lq, device=dev), torch.arange(Lkv, device=dev)

    def id_range(ids, member):  # ids [B, N], member [T, N] -> [B, T] min and max
        mn = torch.where(member[None], ids[:, None], big).amin(-1)
        mx = torch.where(member[None], ids[:, None], -big).amax(-1)
        return mn, mx

    n_rows = Lq * G
    r0 = torch.arange(-(-n_rows // TILE), device=dev) * TILE
    i_hi = (r0 + TILE - 1).clamp(max=n_rows - 1) // G
    q_mn, q_mx = id_range(qs, (pos[None] >= (r0 // G)[:, None]) & (pos[None] <= i_hi[:, None]))
    first, last = _first_last((key[None, None] <= (q_offset + i_hi)[None, :, None])
                              & (ks[:, None] >= q_mn[..., None]) & (ks[:, None] <= q_mx[..., None]))
    dq = torch.stack([first // TILE, last // TILE], -1)
    dq[last < 0] = torch.tensor([0, -1], device=dev)

    kv0 = torch.arange(-(-Lkv // TILE), device=dev) * TILE
    k_mn, k_mx = id_range(ks, (key[None] >= kv0[:, None]) & (key[None] < kv0[:, None] + TILE))
    first, last = _first_last((pos[None, None] >= (kv0 - q_offset)[None, :, None])
                              & (qs[:, None] >= k_mn[..., None]) & (qs[:, None] <= k_mx[..., None]))
    dkv = torch.stack([first * G // QR, (last * G + G - 1) // QR], -1)
    dkv[last < 0] = torch.tensor([0, -1], device=dev)
    return dq.to(torch.int32), dkv.to(torch.int32)


def bwd_tile_spans(q_seg, kv_seg, q_offset: int, G: int, Dh: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The tile schedule of the backward kernels: on CUDA tensors as the
    kernels compute it (``gqa_attention_bwd_schedule``, the same device
    functions), on CPU tensors ``bwd_tile_spans_plain``."""
    if q_seg.device.type == "cpu":
        return bwd_tile_spans_plain(q_seg, kv_seg, q_offset, G, Dh)
    _check_device(q_seg)
    B, Lq = q_seg.shape
    Lkv = kv_seg.shape[1]
    _check("q_segment_ids", q_seg, (B, Lq), torch.int32, q_seg.device)
    _check("kv_segment_ids", kv_seg, (B, Lkv), torch.int32, q_seg.device)
    if Dh not in (64, 128):
        raise ValueError(f"unsupported Dh={Dh}")
    dq = torch.empty((B, -(-(Lq * G) // TILE), 2), dtype=torch.int32, device=q_seg.device)
    dkv = torch.empty((B, -(-Lkv // TILE), 2), dtype=torch.int32, device=q_seg.device)
    err = _build.library("gqa_attention_bwd").gqa_attention_bwd_schedule(
        q_seg.data_ptr(), kv_seg.data_ptr(), dq.data_ptr(), dkv.data_ptr(), B, Lq, Lkv, G, Dh,
        int(q_offset), torch.cuda.current_stream(q_seg.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"gqa_attention_bwd schedule kernel launch failed: CUDA error {err}")
    return dq, dkv


def fwd_kernel_info(Dh: int) -> dict[str, int]:
    """What the card reports of the forward kernel at Dh: registers and
    local (spill) bytes per thread, dynamic shared memory per block, and
    resident blocks per SM."""
    out = (ctypes.c_int * 4)()
    err = _build.library("gqa_attention_fwd").gqa_attention_fwd_kernel_info(Dh, out)
    if err:
        raise RuntimeError(f"gqa_attention_fwd_kernel_info failed: CUDA error {err}")
    return dict(zip(("registers", "local_bytes", "smem_bytes", "blocks_per_sm"), out))


def bwd_kernel_info(which: str, Dh: int) -> dict[str, int]:
    """What the card reports of backward kernel ``which`` ("dq" or "dkv") at
    Dh: registers and local (spill) bytes per thread, dynamic shared memory
    per block, and resident blocks per SM."""
    out = (ctypes.c_int * 4)()
    err = _build.library("gqa_attention_bwd").gqa_attention_bwd_kernel_info(("dq", "dkv").index(which), Dh, out)
    if err:
        raise RuntimeError(f"gqa_attention_bwd_kernel_info failed: CUDA error {err}")
    return dict(zip(("registers", "local_bytes", "smem_bytes", "blocks_per_sm"), out))


def mha_packed_gqa_plain(
    q: torch.Tensor,  # [B, Lq, H, Dh]
    k: torch.Tensor,  # [B, Lkv, K, Dh]
    v: torch.Tensor,
    q_segment_ids: torch.Tensor,  # [B, Lq]
    kv_segment_ids: torch.Tensor,  # [B, Lkv]
    q_offset: int = 0,
    scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's arithmetic in plain PyTorch: fp32 scores, probabilities
    cast to v's dtype for P·V, the TPU kernel's fully-masked-row rule.
    Returns (out, lse)."""
    B, Lq, H, Dh = q.shape
    Lkv, K = k.shape[1], k.shape[2]
    G = H // K
    scale = scale if scale is not None else Dh**-0.5
    q5 = q.reshape(B, Lq, K, G, Dh).float()
    s = torch.einsum("bikgd,bjkd->bkgij", q5, k.float()) * scale
    mask = _mask(q_segment_ids, kv_segment_ids, q_offset)  # [B, 1, 1, Lq, Lkv]
    s = s.masked_fill(~mask, _NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m.clamp(min=-1e29)).masked_fill(~mask, 0.0)
    l = p.sum(-1, keepdim=True).clamp(min=1e-30)
    out = torch.einsum("bkgij,bjkd->bkgid", p.to(v.dtype).float(), v.float()) / l
    lse = torch.where(m > 0.5 * _NEG_INF, m + torch.log(l), torch.full_like(m, _NEG_INF))
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Lq, H, Dh).to(q.dtype)
    return out, lse[..., 0].permute(0, 3, 1, 2).contiguous()


def mha_packed_gqa_bwd_plain(
    q: torch.Tensor,  # [B, Lq, H, Dh]
    k: torch.Tensor,  # [B, Lkv, K, Dh]
    v: torch.Tensor,
    q_segment_ids: torch.Tensor,
    kv_segment_ids: torch.Tensor,
    q_offset: int,
    scale: float,
    out: torch.Tensor,  # [B, Lq, H, Dh], the forward's output
    lse: torch.Tensor,  # [B, Lq, K, G] fp32
    do: torch.Tensor,  # [B, Lq, H, Dh], the output's gradient
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels' arithmetic in plain PyTorch: delta = rowsum(dO
    * O) in fp32, then ``_bwd_plain``. Returns (dq, dk, dv) in the inputs'
    dtypes."""
    return _bwd_plain(q, k, v, q_segment_ids, kv_segment_ids, q_offset, scale, lse, _delta(out, do, k.shape[2]), do)


def _query_blocks(Lq: int, Lkv: int, q_offset: int, block: int):
    """(first query, end query, keys it can see) of each block of ``block``
    queries: keys past a block's last query are masked for all of it."""
    for i in range(0, Lq, block):
        j = min(Lq, i + block)
        yield i, j, min(Lkv, q_offset + j)


def mha_packed_gqa_plain_blocked(q, k, v, q_segment_ids, kv_segment_ids, q_offset: int = 0,
                                 scale: float | None = None, block: int = 2048) -> tuple[torch.Tensor, torch.Tensor]:
    """``mha_packed_gqa_plain`` by blocks of ``block`` queries, each against
    the keys it can see: the same function with the fp32 scores of one block
    live at a time, for rows whose whole score matrix would not fit (L 32,768
    at 14 heads is 60 GB)."""
    outs, lses = [], []
    for i, j, e in _query_blocks(q.shape[1], k.shape[1], q_offset, block):
        out, lse = mha_packed_gqa_plain(q[:, i:j], k[:, :e], v[:, :e], q_segment_ids[:, i:j],
                                        kv_segment_ids[:, :e], q_offset + i, scale)
        outs.append(out)
        lses.append(lse)
    return torch.cat(outs, 1), torch.cat(lses, 1)


def mha_packed_gqa_bwd_plain_blocked(q, k, v, q_segment_ids, kv_segment_ids, q_offset: int, scale: float, out, lse,
                                     do, block: int = 2048) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``mha_packed_gqa_bwd_plain`` by blocks of ``block`` queries: dq of
    each block whole, dk and dv summed over the blocks in fp32 and rounded
    once at the end."""
    delta = _delta(out, do, k.shape[2])
    dqs = []
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    for i, j, e in _query_blocks(q.shape[1], k.shape[1], q_offset, block):
        dq_b, dk_b, dv_b = _bwd_plain(q[:, i:j], k[:, :e], v[:, :e], q_segment_ids[:, i:j], kv_segment_ids[:, :e],
                                      q_offset + i, scale, lse[:, i:j], delta[:, i:j], do[:, i:j], partial=True)
        dqs.append(dq_b)
        dk[:, :e] += dk_b
        dv[:, :e] += dv_b
    return torch.cat(dqs, 1), dk.to(k.dtype), dv.to(v.dtype)


def _delta(out: torch.Tensor, do: torch.Tensor, K: int) -> torch.Tensor:
    """rowsum(dO * O) in fp32, [B, Lq, K, G] (an einsum outside the kernels
    in the JAX package too)."""
    B, Lq, H, _ = out.shape
    return (do.float() * out.float()).sum(-1).reshape(B, Lq, K, H // K)


def _bwd_plain(q, k, v, q_segment_ids, kv_segment_ids, q_offset, scale, lse, delta, do, partial=False):
    """P recomputed as exp(s - lse) where the mask holds, dS = P (dP -
    delta); P rounded to dO's dtype for dV, dS to q's dtype for dK and to
    k's dtype for dQ, as the kernels round. ``partial`` keeps dk and dv in
    fp32, for a caller that sums them over blocks of queries."""
    B, Lq, H, Dh = q.shape
    K = k.shape[2]
    G = H // K
    q5 = q.reshape(B, Lq, K, G, Dh).float()
    do5 = do.reshape(B, Lq, K, G, Dh).float()
    kf, vf = k.float(), v.float()
    s = torch.einsum("bikgd,bjkd->bkgij", q5, kf) * scale
    mask = _mask(q_segment_ids, kv_segment_ids, q_offset)
    rows = lse.permute(0, 2, 3, 1)[..., None]  # [B, K, G, Lq, 1]
    p = torch.exp((s - rows).masked_fill(~mask, float("-inf")))
    dp = torch.einsum("bikgd,bjkd->bkgij", do5, vf)
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    dv = torch.einsum("bkgij,bikgd->bjkd", p.to(do.dtype).float(), do5)
    dk = torch.einsum("bkgij,bikgd->bjkd", ds.to(q.dtype).float(), q5) * scale
    dq = torch.einsum("bkgij,bjkd->bikgd", ds.to(k.dtype).float(), kf) * scale
    if partial:
        return dq.reshape(B, Lq, H, Dh).to(q.dtype), dk, dv
    return dq.reshape(B, Lq, H, Dh).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _mask(q_segment_ids, kv_segment_ids, q_offset) -> torch.Tensor:
    """[B, 1, 1, Lq, Lkv]: causal by global flat index and same segment."""
    Lq, Lkv = q_segment_ids.shape[1], kv_segment_ids.shape[1]
    i = torch.arange(Lq, device=q_segment_ids.device)[:, None] + q_offset
    j = torch.arange(Lkv, device=q_segment_ids.device)[None, :]
    mask = (i >= j)[None] & (q_segment_ids[:, :, None] == kv_segment_ids[:, None, :])
    return mask[:, None, None]


def _check_device(t) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"no kernel for device {t.device}")


def _check(name, t, shape, dtype, dev) -> None:
    if t.device != dev or t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{name}: {t.dtype} {tuple(t.shape)} on {t.device}, the kernel takes "
            f"{dtype} {tuple(shape)} on {dev}"
        )
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _check_inputs(q, k, v, q_seg, kv_seg) -> None:
    B, Lq, H, Dh = q.shape
    Lkv, K = k.shape[1], k.shape[2]
    if Dh not in (64, 128) or H % K:
        raise ValueError(f"unsupported shape H={H} K={K} Dh={Dh}")
    bf, dev = torch.bfloat16, q.device
    _check("q", q, (B, Lq, H, Dh), bf, dev)
    _check("k", k, (B, Lkv, K, Dh), bf, dev)
    _check("v", v, (B, Lkv, K, Dh), bf, dev)
    _check("q_segment_ids", q_seg, (B, Lq), torch.int32, dev)
    _check("kv_segment_ids", kv_seg, (B, Lkv), torch.int32, dev)


def _check_bwd_inputs(q, k, v, q_seg, kv_seg, lse, delta, do) -> None:
    _check_inputs(q, k, v, q_seg, kv_seg)
    B, Lq, H, Dh = q.shape
    K = k.shape[2]
    _check("do", do, (B, Lq, H, Dh), torch.bfloat16, q.device)
    _check("lse", lse, (B, Lq, K, H // K), torch.float32, q.device)
    _check("delta", delta, (B, Lq, K, H // K), torch.float32, q.device)


def _gqa_fwd_cuda(q, k, v, q_seg, kv_seg, q_offset, scale):
    global launches
    B, Lq, H, Dh = q.shape
    Lkv, K = k.shape[1], k.shape[2]
    dev = q.device
    _check_inputs(q, k, v, q_seg, kv_seg)
    out = torch.empty_like(q)
    lse = torch.empty((B, Lq, K, H // K), dtype=torch.float32, device=dev)
    lib = _build.library("gqa_attention_fwd")
    err = lib.gqa_attention_fwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q_seg.data_ptr(), kv_seg.data_ptr(),
        out.data_ptr(), lse.data_ptr(), B, Lq, Lkv, H, K, Dh, int(q_offset),
        float(scale), fwd_splits(B, Lq, Lkv, K, H // K, Dh), torch.cuda.current_stream(dev).cuda_stream,
    )
    if err:
        raise RuntimeError(f"gqa_attention_fwd kernel launch failed: CUDA error {err}")
    launches += 1
    return out, lse


def mha_packed_gqa_bwd_dq(q, k, v, q_seg, kv_seg, q_offset, scale, lse, delta, do) -> torch.Tensor:
    """Kernel #3: dq [B, Lq, H, Dh]. CPU tensors take the plain version;
    CUDA tensors launch the kernel (bf16 q/k/v/dO, fp32 lse and delta
    [B, Lq, K, G], int32 segment ids) or raise."""
    global dq_launches
    if q.device.type == "cpu":
        return _bwd_plain(q, k, v, q_seg, kv_seg, q_offset, scale, lse, delta, do)[0]
    _check_device(q)
    _check_bwd_inputs(q, k, v, q_seg, kv_seg, lse, delta, do)
    B, Lq, H, Dh = q.shape
    Lkv, K = k.shape[1], k.shape[2]
    dq = torch.empty_like(q)
    err = _build.library("gqa_attention_bwd").gqa_attention_bwd_dq_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), q_seg.data_ptr(), kv_seg.data_ptr(), dq.data_ptr(),
        B, Lq, Lkv, H, K, Dh, int(q_offset), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"gqa_attention_bwd dq kernel launch failed: CUDA error {err}")
    dq_launches += 1
    return dq


def mha_packed_gqa_bwd_dkv(q, k, v, q_seg, kv_seg, q_offset, scale, lse, delta, do):
    """Kernel #4: (dk, dv) [B, Lkv, K, Dh], summed over the G query heads
    of each kv head. CPU tensors take the plain version; CUDA tensors launch
    the kernel, ``dkv_splits`` blocks per key tile in one cluster, or raise."""
    global dkv_launches
    if q.device.type == "cpu":
        return _bwd_plain(q, k, v, q_seg, kv_seg, q_offset, scale, lse, delta, do)[1:]
    _check_device(q)
    _check_bwd_inputs(q, k, v, q_seg, kv_seg, lse, delta, do)
    B, Lq, H, Dh = q.shape
    Lkv, K = k.shape[1], k.shape[2]
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    err = _build.library("gqa_attention_bwd").gqa_attention_bwd_dkv_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), q_seg.data_ptr(), kv_seg.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        B, Lq, Lkv, H, K, Dh, int(q_offset), float(scale), dkv_splits(B, Lq, Lkv, K, H // K, Dh),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"gqa_attention_bwd dkv kernel launch failed: CUDA error {err}")
    dkv_launches += 1
    return dk, dv


def mha_packed_gqa_bwd(q, k, v, q_seg, kv_seg, q_offset, scale, out, lse, do):
    """(dq, dk, dv): delta in plain torch, then kernels #3 and #4 (their
    plain versions for CPU tensors)."""
    delta = _delta(out, do, k.shape[2])
    dq = mha_packed_gqa_bwd_dq(q, k, v, q_seg, kv_seg, q_offset, scale, lse, delta, do)
    dk, dv = mha_packed_gqa_bwd_dkv(q, k, v, q_seg, kv_seg, q_offset, scale, lse, delta, do)
    return dq, dk, dv


class _GQAAttention(torch.autograd.Function):
    """Forward: kernel #2, ``fwd_splits`` blocks per q tile in one cluster
    (or its plain version on the CPU), saving q, k, v,
    out and lse. Backward: ``mha_packed_gqa_bwd``."""

    @staticmethod
    def forward(ctx, q, k, v, q_seg, kv_seg, q_offset, scale):
        if q.device.type == "cpu":
            out, lse = mha_packed_gqa_plain(q, k, v, q_seg, kv_seg, q_offset, scale)
        else:
            _check_device(q)
            out, lse = _gqa_fwd_cuda(q, k, v, q_seg, kv_seg, q_offset, scale)
        ctx.save_for_backward(q, k, v, q_seg, kv_seg, out, lse)
        ctx.q_offset, ctx.scale = q_offset, scale
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, q_seg, kv_seg, out, lse = ctx.saved_tensors
        dq, dk, dv = mha_packed_gqa_bwd(
            q, k, v, q_seg, kv_seg, ctx.q_offset, ctx.scale, out, lse, dout.contiguous()
        )
        return dq, dk, dv, None, None, None, None


def mha_packed_gqa(
    q: torch.Tensor,  # [B, Lq, H, Dh]
    k: torch.Tensor,  # [B, Lkv, K, Dh]
    v: torch.Tensor,
    q_segment_ids: torch.Tensor,  # [B, Lq] int32
    kv_segment_ids: torch.Tensor,  # [B, Lkv] int32
    q_offset: int = 0,
    scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Packed GQA attention → (out, lse), differentiable in q, k and v. CPU
    tensors take the plain versions; CUDA tensors launch the kernels (bf16
    q/k/v, int32 segment ids, contiguous, Dh 64 or 128) or raise."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    return _GQAAttention.apply(q, k, v, q_segment_ids, kv_segment_ids, int(q_offset), float(scale))


def mha_packed_gqa_simple(
    q: torch.Tensor,  # [B, L, H, Dh]
    k: torch.Tensor,
    v: torch.Tensor,
    segment_ids: torch.Tensor,  # [B, L]
    position_ids: torch.Tensor | None = None,  # unused (flat-index causality)
    scale: float | None = None,
) -> torch.Tensor:
    """Drop-in for ``mha_packed`` (q and kv cover the same packed row)."""
    return mha_packed_gqa(q, k, v, segment_ids, segment_ids, 0, scale)[0]


_build.declare(
    "gqa_attention_fwd",
    "gqa_attention_fwd_bf16",
    [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
)
_build.declare("gqa_attention_fwd", "gqa_attention_fwd_kernel_info", [ctypes.c_int, ctypes.c_void_p])
_build.declare(
    "gqa_attention_bwd",
    "gqa_attention_bwd_dq_bf16",
    [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p],
)
_build.declare(
    "gqa_attention_bwd",
    "gqa_attention_bwd_dkv_bf16",
    [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
)
_build.declare(
    "gqa_attention_bwd",
    "gqa_attention_bwd_schedule",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
)
_build.declare(
    "gqa_attention_bwd",
    "gqa_attention_bwd_kernel_info",
    [ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
)
