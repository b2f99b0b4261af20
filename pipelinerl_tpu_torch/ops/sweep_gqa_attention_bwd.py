"""Time variants of the GQA backward kernels (#3 dq, #4 dk/dv) on the card.

    python -m pipelinerl_tpu_torch.ops.sweep_gqa_attention_bwd [--rounds 3]

At the training row (one packed row of L 4096 in 8 segments, H 14, K 2, Dh
64), each round times, in turn within one process:
- #4 at split counts S = 1, 2, 4 and 8 (``dkv_splits`` overridden), beside
  #3, with the shipped source;
- the other design for #4's reduction: each block writes its fp32 partial
  to device memory and a second kernel, launched as a programmatic
  dependent, sums them in rank order (a copy of the source with the
  cluster epilogue swapped for that one, built into ``_build/sweep/``), at
  S = 2, 4 and 8;
- a ring of 3 stages in both kernels in place of 2 (another copy);
- the schedule alone: the kernel that writes both kernels' spans
  (``bwd_tile_spans``).
Each time is the mean of one call over a CUDA-graph replay of 32 calls,
CUDA events around it, over input sets that together exceed the 50 MB L2.
Each variant's dq/dk/dv are also compared with the plain backward of the
first set. It needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess

import torch

from . import _build
from . import gqa_attention as gattn
from .sweep_decode_attention import _time_ms

L, SEGMENTS, H, K, DH = 4096, 8, 14, 2, 64

# #4's epilogue as a merge of partials in device memory: the lines of the
# shipped source each variant replaces, and what replaces them
_RING = ("constexpr int kStages = 2;", "constexpr int kStages = 3;")
_PARTIALS = [
    (
        "  cg::cluster_group cluster = cg::this_cluster();\n"
        "  const int S = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();\n",
        "  const int S = gridDim.z, rank = blockIdx.z;\n",
    ),
    (
        """  cluster.sync();  // every rank's partial is written and visible to the cluster
  store_dkv<DH>(cluster, part, dk, dv, (((int64_t)b * Lkv + kv0) * K + kh) * DH, (int64_t)K * DH,
                n_kv, scale);
  cluster.sync();  // this block's shared memory stays until every rank has read it
""",
        """  asm volatile("griddepcontrol.launch_dependents;\\n" ::);
  __syncthreads();
  float* gp = g_part + (((int64_t)blockIdx.y * gridDim.x + blockIdx.x) * S + rank) * 2 * kTile * DH;
  for (int e = threadIdx.x; e < 2 * kTile * DH / 4; e += kThreads) {
    const int which = e / (kTile * DH / 4), rem = e % (kTile * DH / 4);
    const int key = rem / (DH / 4), c4 = (rem % (DH / 4)) * 4;
    *reinterpret_cast<float4*>(gp + (which * kTile + key) * DH + c4) =
        *reinterpret_cast<const float4*>(which ? &part.dv[key][c4] : &part.dk[key][c4]);
  }
""",
    ),
    (
        "template <int DH, int QR>\nstruct DkvStage {\n",
        """constexpr int64_t kPartFloats = int64_t(1) << 24;
__device__ float g_part[kPartFloats];

template <int DH>
__global__ void __launch_bounds__(kThreads) merge_dkv_kernel(__nv_bfloat16* dk, __nv_bfloat16* dv, int Lkv,
                                                             int K, int S, float scale) {
  asm volatile("griddepcontrol.wait;\\n" ::: "memory");
  const int kv0 = blockIdx.x * kTile, b = blockIdx.y / K, kh = blockIdx.y % K;
  const float* gp = g_part + ((int64_t)blockIdx.y * gridDim.x + blockIdx.x) * S * 2 * kTile * DH;
  for (int e = threadIdx.x; e < 2 * kTile * DH / 4; e += kThreads) {
    const int which = e / (kTile * DH / 4), rem = e % (kTile * DH / 4);
    const int key = rem / (DH / 4), c4 = (rem % (DH / 4)) * 4;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int r = 0; r < S; ++r) {
      const float4 x = *reinterpret_cast<const float4*>(gp + ((r * 2 + which) * kTile + key) * DH + c4);
      a.x += x.x;
      a.y += x.y;
      a.z += x.z;
      a.w += x.w;
    }
    if (kv0 + key >= Lkv) continue;
    const float sc = which ? 1.f : scale;
    __nv_bfloat16* o = (which ? dv : dk) + (((int64_t)b * Lkv + kv0 + key) * K + kh) * DH + c4;
    *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(a.x * sc, a.y * sc);
    *reinterpret_cast<__nv_bfloat162*>(o + 2) = __floats2bfloat162_rn(a.z * sc, a.w * sc);
  }
}

template <int DH, int QR>
struct DkvStage {
""",
    ),
    (
        """  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, gqa_bwd_dkv_kernel<DH, QR>, (const __nv_bfloat16*)q,
                                 (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
                                 (const __nv_bfloat16*)dout, (const float*)lse, (const float*)delta,
                                 (const int*)q_seg, (const int*)kv_seg, (__nv_bfloat16*)dk,
                                 (__nv_bfloat16*)dv, Lq, Lkv, H, K, q_offset, scale);
""",
        """  (void)cluster;
  if ((int64_t)cfg.gridDim.x * cfg.gridDim.y * splits * 2 * kTile * DH > kPartFloats)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaLaunchKernelEx(&cfg, gqa_bwd_dkv_kernel<DH, QR>, (const __nv_bfloat16*)q,
                                       (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
                                       (const __nv_bfloat16*)dout, (const float*)lse, (const float*)delta,
                                       (const int*)q_seg, (const int*)kv_seg, (__nv_bfloat16*)dk,
                                       (__nv_bfloat16*)dv, Lq, Lkv, H, K, q_offset, scale);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute pdl;
  pdl.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t mcfg = {};
  mcfg.gridDim = dim3(cfg.gridDim.x, cfg.gridDim.y);
  mcfg.blockDim = dim3(kThreads);
  mcfg.stream = st;
  mcfg.attrs = &pdl;
  mcfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&mcfg, merge_dkv_kernel<DH>, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, Lkv, K,
                                 splits, scale);
""",
    ),
]


def _build_variants() -> dict:
    src = (_build.CSRC_DIR / "gqa_attention_bwd.cu").read_text()
    variants = {"ring 3": [_RING], "partials + merge": _PARTIALS}
    out = _build.BUILD_DIR / "sweep"
    out.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, edits in variants.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"the source changed where variant {name!r} edits it; update this sweep")
            text = text.replace(old, new)
        stem = "bwd_" + name.replace(" ", "_").replace("+", "and")
        cu, so = out / f"{stem}.cu", out / f"{stem}.so"
        cu.write_text(text)
        jobs[name] = (so, subprocess.Popen(_build.nvcc_command(cu, so), stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {name!r}:\n{log}")
        lib = ctypes.CDLL(str(so))
        for function, argtypes in _build._SIGNATURES["gqa_attention_bwd"]:
            fn = getattr(lib, function)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
        libs[name] = lib
    return libs


def _inputs(gen, dev):
    """(q, k, v, q_seg, kv_seg, q_offset, scale, out, lse, do, delta) at the
    training row, out and lse from kernel #2."""
    bf = torch.bfloat16
    q = torch.randn((1, L, H, DH), generator=gen, device=dev).to(bf)
    k = torch.randn((1, L, K, DH), generator=gen, device=dev).to(bf)
    v = torch.randn((1, L, K, DH), generator=gen, device=dev).to(bf)
    seg = (torch.arange(L, device=dev) * SEGMENTS // L).to(torch.int32)[None].contiguous()
    out, lse = gattn.mha_packed_gqa(q, k, v, seg, seg)
    do = torch.randn((1, L, H, DH), generator=gen, device=dev).to(bf)
    return q, k, v, seg, seg, 0, DH**-0.5, out, lse, do, gattn._delta(out, do, K)


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
    shipped = _build.library("gqa_attention_bwd")
    libs = _build_variants()
    gen = torch.Generator(device=dev).manual_seed(0)
    sets = [_inputs(gen, dev) for _ in range(5)]  # about 25 MB each
    ref = gattn.mha_packed_gqa_bwd_plain(*sets[0][:10])

    def dq(a):
        return gattn.mha_packed_gqa_bwd_dq(*a[:7], a[8], a[10], a[9])

    def dkv(a):
        return gattn.mha_packed_gqa_bwd_dkv(*a[:7], a[8], a[10], a[9])

    auto = gattn.dkv_splits(1, L, L, K, H // K, DH)
    variants = [(f"S={s}", shipped, s) for s in (1, 2, 4, 8)]
    variants += [(f"partials + merge, S={s}", libs["partials + merge"], s) for s in (2, 4, 8)]
    variants.append((f"ring 3, S={auto}", libs["ring 3"], auto))
    saved = gattn.dkv_splits, dict(_build._LIBS)
    try:
        for rnd in range(args.rounds):
            for name, lib, splits in variants:
                _build._LIBS["gqa_attention_bwd"] = lib
                gattn.dkv_splits = lambda *_, s=splits: s
                got = (dq(sets[0]), *dkv(sets[0]))
                err = max((g.float() - r.float()).abs().max().item() for g, r in zip(got, ref))
                dq_ms = _time_ms([lambda a=a: dq(a) for a in sets])
                dkv_ms = _time_ms([lambda a=a: dkv(a) for a in sets])
                print(f"round {rnd} {name}: #3 {dq_ms * 1e3:.2f} us, #4 {dkv_ms * 1e3:.2f} us, "
                      f"sum {(dq_ms + dkv_ms) * 1e3:.2f} us (max abs err {err:.2e} against the plain backward)",
                      flush=True)
            _build._LIBS["gqa_attention_bwd"] = shipped
            ms = _time_ms([lambda a=a: gattn.bwd_tile_spans(a[3], a[4], 0, H // K, DH) for a in sets])
            print(f"round {rnd} the schedule alone (both kernels' spans, one launch): {ms * 1e3:.2f} us", flush=True)
    finally:
        gattn.dkv_splits = saved[0]
        _build._LIBS.clear()
        _build._LIBS.update(saved[1])


if __name__ == "__main__":
    main()
