"""Time variants of the GQA forward kernel (#2) on the card.

    python -m pipelinerl_tpu_torch.ops.sweep_gqa_attention_fwd [--rounds 3]

At thirteen shapes (H 14, K 2, Dh 64): the training row (one packed row of
L 4096 in 8 segments), q_offset 384 with Lq 256 < Lkv 640 (B 2, 3
segments), two prefills (B 8, L 128, the slab engine's bucket; B 1, L
512, a lone prompt in the paged engine's larger bucket),
``forward_extend`` tails of 128 queries as the paged engine batches them
(B 8 after a padded prefix of
4 pages of 128, 384 valid; and its partial batches of B 1, 2 and 4 after
page buckets of 8 and 16, one page of pad each), and two long spans over
short grids, one segment each: a resumed turn (B 1, 128 queries at
q_offset 3968) and tails at the prefix cache's longest prefix (B 8, 128
queries at q_offset 1920). Each round times, in turn within one process:
- #2 at every split count S from 1 to 8 (``fwd_splits`` overridden,
  capped at the shape's key tiles), with the shipped source;
- copies of the source built into ``_build/sweep/``: a ring of 3 stages in
  place of 2, at S = 1, 2, 4, 8 and ``fwd_splits``' choice; at S 1 only, a
  launch without the cluster attribute, and the epilogue through
  ``store_merged`` (shared memory and DSMEM) in place of the direct store
  from the fragments; 4 resident blocks per SM at Dh 64 in place of 3 (a
  cap of 128 registers), at S = 1, 2, 4, 8 and its own ``fwd_splits``
  choice (each variant's registers, spills and blocks per SM as the card
  reports them are printed first);
- one ``scaled_dot_product_attention`` call with a boolean mask, the
  yardstick;
- the schedule alone: the kernel that writes the backward's spans, whose
  dq half is #2's (``bwd_tile_spans``).
Each time is the mean of one call over a CUDA-graph replay of 32 calls,
CUDA events around it, over input sets that together exceed the 50 MB L2.
Each variant's out and lse are also compared with the plain forward of the
first set. It needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess

import torch
import torch.nn.functional as F

from ..models.transformer import extend_segments
from . import _build
from . import gqa_attention as gattn
from .sweep_decode_attention import _time_ms

H, K, DH = 14, 2, 64
# (label, B, Lq, Lkv, equal segments of the row, or for a forward_extend
# tail the valid prefix tokens (a string))
SHAPES = [
    ("training row L 4096, 8 segments", 1, 4096, 4096, 8),
    ("q_offset 384, Lq 256 < Lkv 640", 2, 256, 640, 3),
    ("prefill B 8, L 128", 8, 128, 128, 1),
    ("prefill B 1, L 512", 1, 512, 512, 1),
    ("forward_extend tail B 8, Lt 128, q_offset 512", 8, 128, 640, "384"),
    ("forward_extend tail B 1, Lt 128, q_offset 1024", 1, 128, 1152, "896"),
    ("forward_extend tail B 2, Lt 128, q_offset 1024", 2, 128, 1152, "896"),
    ("forward_extend tail B 4, Lt 128, q_offset 1024", 4, 128, 1152, "896"),
    ("forward_extend tail B 1, Lt 128, q_offset 2048", 1, 128, 2176, "1920"),
    ("forward_extend tail B 2, Lt 128, q_offset 2048", 2, 128, 2176, "1920"),
    ("forward_extend tail B 4, Lt 128, q_offset 2048", 4, 128, 2176, "1920"),
    ("resumed turn B 1, Lt 128, q_offset 3968", 1, 128, 4096, 1),
    ("tails B 8, Lt 128, q_offset 1920", 8, 128, 2048, 1),
]
# each variant: the line of the shipped source it replaces and with what,
# the split counts it runs at (None: as the shipped source), and the blocks
# per SM at Dh 64 that its fwd_splits counts (None: FWD_BLOCKS_PER_SM's)
VARIANTS = {
    "ring 3": ("constexpr int kStages = 2;", "constexpr int kStages = 3;", None, None),
    "no cluster attribute": ("  cfg.numAttrs = 1;", "  cfg.numAttrs = splits > 1;", (1,), None),
    "epilogue through store_merged": ("  if (S == 1) {", "  if (false) {", (1,), None),
    "4 blocks per SM": ("__launch_bounds__(kThreads, DH == 64 ? 3 : 2)",
                        "__launch_bounds__(kThreads, DH == 64 ? 4 : 2)", None, 4),
}


def _build_variants() -> dict:
    src = (_build.CSRC_DIR / "gqa_attention_fwd.cu").read_text()
    out = _build.BUILD_DIR / "sweep"
    out.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, (old, new, _, _) in VARIANTS.items():
        if src.count(old) != 1:
            raise RuntimeError(f"the source changed where variant {name!r} edits it; update this sweep")
        stem = "fwd_" + name.replace(" ", "_")
        cu, so = out / f"{stem}.cu", out / f"{stem}.so"
        cu.write_text(src.replace(old, new))
        jobs[name] = (so, subprocess.Popen(_build.nvcc_command(cu, so), stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {name!r}:\n{log}")
        lib = ctypes.CDLL(str(so))
        for function, argtypes in _build._SIGNATURES["gqa_attention_fwd"]:
            fn = getattr(lib, function)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
        libs[name] = lib
    return libs


def _inputs(gen, B, Lq, Lkv, segs, dev):
    """(q, k, v, q_seg, kv_seg, q_offset): ``segs`` equal segments over the
    row, or (a string) a tail of Lq queries after a padded prefix of Lkv -
    Lq tokens whose first int(segs) are valid, laid out as
    ``forward_extend`` lays it out."""
    bf = torch.bfloat16
    q = torch.randn((B, Lq, H, DH), generator=gen, device=dev).to(bf)
    k = torch.randn((B, Lkv, K, DH), generator=gen, device=dev).to(bf)
    v = torch.randn((B, Lkv, K, DH), generator=gen, device=dev).to(bf)
    if isinstance(segs, str):
        q_seg, kv_seg = extend_segments(torch.full((B,), int(segs), device=dev), Lkv - Lq, Lq)
    else:
        kv_seg = (torch.arange(Lkv, device=dev) * segs // Lkv).to(torch.int32)[None].expand(B, Lkv).contiguous()
        q_seg = kv_seg[:, Lkv - Lq :].contiguous()
    return q, k, v, q_seg, kv_seg, Lkv - Lq


def _sdpa_args(a):
    q, k, v, q_seg, kv_seg, q_off = a
    i = torch.arange(q.shape[1], device=q.device)[:, None] + q_off
    j = torch.arange(k.shape[1], device=q.device)[None, :]
    mask = ((i >= j)[None] & (q_seg[:, :, None] == kv_seg[:, None, :]))[:, None]
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), mask


def _auto(B, Lq, Lkv, blocks):
    """``fwd_splits``' choice, counting ``blocks`` resident blocks per SM at
    Dh 64 (None: ``FWD_BLOCKS_PER_SM``'s)."""
    saved = dict(gattn.FWD_BLOCKS_PER_SM)
    if blocks is not None:
        gattn.FWD_BLOCKS_PER_SM[DH] = blocks
    try:
        return gattn.fwd_splits(B, Lq, Lkv, K, H // K, DH)
    finally:
        gattn.FWD_BLOCKS_PER_SM.update(saved)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the sweep runs only on an NVIDIA GPU")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    shipped = _build.library("gqa_attention_fwd")
    _build.library("gqa_attention_bwd")
    libs = _build_variants()
    for name, lib in [("shipped", shipped), *libs.items()]:
        info = (ctypes.c_int * 4)()
        if lib.gqa_attention_fwd_kernel_info(DH, info):
            raise RuntimeError(f"kernel info failed for {name}")
        print(f"{name}: {info[0]} registers, {info[1]} local bytes, {info[3]} blocks per SM at Dh {DH}", flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = []
    for label, B, Lq, Lkv, segs in SHAPES:
        first = _inputs(gen, B, Lq, Lkv, segs, dev)
        set_bytes = sum(t.numel() * t.element_size() for t in first[:5])
        sets = [first] + [_inputs(gen, B, Lq, Lkv, segs, dev) for _ in range(max(1, -(-60_000_000 // set_bytes)) - 1)]
        n_kt = -(-Lkv // gattn.TILE)
        fixed = {min(s, n_kt) for s in (1, 2, 4, 8)}
        auto = _auto(B, Lq, Lkv, None)
        runs = [("shipped", shipped, s, auto) for s in range(1, min(gattn.MAX_SPLITS, n_kt) + 1)]
        for name, (_, _, only, blocks) in VARIANTS.items():
            auto = _auto(B, Lq, Lkv, blocks)
            runs += [(name, libs[name], s, auto) for s in (only or sorted(fixed | {auto}))]
        cases.append((label, sets, runs, gattn.mha_packed_gqa_plain(*first)))
    saved = gattn.fwd_splits, dict(_build._LIBS)
    try:
        for rnd in range(args.rounds):
            for label, sets, runs, (ref_out, ref_lse) in cases:
                times = []
                for name, lib, s, auto in runs:
                    _build._LIBS["gqa_attention_fwd"] = lib
                    gattn.fwd_splits = lambda *_, s=s: s
                    out, lse = gattn.mha_packed_gqa(*sets[0])
                    err = max((out.float() - ref_out.float()).abs().max().item(), (lse - ref_lse).abs().max().item())
                    ms = _time_ms([lambda a=a: gattn.mha_packed_gqa(*a) for a in sets])
                    times.append(f"{name + ', ' if lib is not shipped else ''}S={s}"
                                 f"{' (fwd_splits)' if s == auto else ''} {ms * 1e3:.2f} us (err {err:.1e})")
                _build._LIBS["gqa_attention_fwd"] = shipped
                gattn.fwd_splits = saved[0]
                sdpa = [_sdpa_args(a) for a in sets]
                sdpa_ms = _time_ms([lambda a=a: F.scaled_dot_product_attention(a[0], a[1], a[2], attn_mask=a[3],
                                                                                enable_gqa=True) for a in sdpa])
                del sdpa
                sched_ms = _time_ms([lambda a=a: gattn.bwd_tile_spans(a[3], a[4], a[5], H // K, DH) for a in sets])
                print(f"round {rnd} {label}: " + ", ".join(times)
                      + f"; SDPA {sdpa_ms * 1e3:.2f} us; the schedule alone (both halves) {sched_ms * 1e3:.2f} us",
                      flush=True)
    finally:
        gattn.fwd_splits = saved[0]
        _build._LIBS.clear()
        _build._LIBS.update(saved[1])


if __name__ == "__main__":
    main()
