"""Time variants of the decode-attention kernels' source on the card.

    python -m pipelinerl_tpu_torch.ops.sweep_decode_attention [--rounds 3]

Builds copies of ``csrc/decode_attention.cu`` with other ring depths
(``kStages``) and split sizes (``kSplitRows``) into ``_build/sweep/`` and
times, for each variant in turn within one process: kernel #1 at the slab
engine's shape (S 64, H 14, K 2, Dh 64, W 16, T_alloc 344), and kernel #5 at
the paged engine's case (i) (33 pages of 128, one slot of 4,192 rows) and on
16-page tables with lengths up to 1,000. Each time is the mean of one call
over a CUDA-graph replay of 32 calls, CUDA events around it, over input sets
that together exceed the 50 MB L2. It needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess

import numpy as np
import torch

from . import _build
from . import decode_attention as dattn
from . import paged_attention as pattn

VARIANTS = [(2, 256), (3, 256), (4, 256), (2, 128), (2, 512)]  # (kStages, kSplitRows)


def _time_ms(fns, iters: int = 32) -> float:
    for f in fns:
        f()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fns[i % len(fns)]()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _build_variants() -> dict:
    src = (_build.CSRC_DIR / "decode_attention.cu").read_text()
    if "constexpr int kStages = 2;" not in src or "constexpr int kSplitRows = 256;" not in src:
        raise RuntimeError("the source's kStages or kSplitRows line changed; update this sweep")
    out = _build.BUILD_DIR / "sweep"
    out.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for stages, rows in VARIANTS:
        text = src.replace("constexpr int kStages = 2;", f"constexpr int kStages = {stages};").replace(
            "constexpr int kSplitRows = 256;", f"constexpr int kSplitRows = {rows};")
        cu, so = out / f"s{stages}_c{rows}.cu", out / f"s{stages}_c{rows}.so"
        cu.write_text(text)
        jobs[(stages, rows)] = (so, subprocess.Popen(_build.nvcc_command(cu, so), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {key}:\n{log}")
        lib = ctypes.CDLL(str(so))
        for function, argtypes in _build._SIGNATURES["decode_attention"]:
            fn = getattr(lib, function)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
        libs[key] = lib
    return libs


def _inputs(gen, dev):
    bf = torch.bfloat16

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf)

    H, K, Dh = 14, 2, 64
    rng = np.random.default_rng(0)
    S, W, T = 64, 16, 344
    lens = torch.tensor(rng.integers(0, T - W + 1, S), dtype=torch.int32, device=dev)
    slab = [(rnd(S, H, Dh), rnd(S, K, Dh), rnd(S, K, Dh), rnd(S, T, K, Dh), rnd(S, T, K, Dh), lens,
             rnd(W, S, K, Dh), rnd(W, S, K, Dh), W - 1) for _ in range(8)]

    def paged(maxb, nb, lens):
        S, BT, W = len(lens), 128, 32
        pages = torch.randperm(nb, generator=torch.Generator().manual_seed(1))[: S * maxb].reshape(S, maxb)
        held = torch.arange(maxb)[None] * BT < torch.tensor(lens)[:, None].clamp(min=1)
        table = torch.where(held, pages, -1).to(torch.int32).to(dev)
        return (rnd(S, H, Dh), rnd(S, K, Dh), rnd(S, K, Dh), rnd(nb, BT, K, Dh), rnd(nb, BT, K, Dh), table,
                torch.tensor(lens, dtype=torch.int32, device=dev), rnd(W, S, K, Dh), rnd(W, S, K, Dh), W - 1)

    case_i = [0, 1, 128, 129, 33 * 128 - 32] + [int(x) for x in rng.integers(0, 1000, 91)]
    sixteen = [int(x) for x in rng.integers(0, 1001, 96)]
    slab_fns = dattn.decode_attention_staged_ragged, dattn.decode_attention_staged_ragged_plain
    paged_fns = pattn.paged_decode_attention, pattn.paged_decode_attention_plain
    return {  # name: (kernel wrapper, plain version, input sets); pools of distinct pages per slot
        "#1 slab": (*slab_fns, slab),
        "#5 case (i)": (*paged_fns, [paged(33, 96 * 33, case_i) for _ in range(4)]),
        "#5 16 pages": (*paged_fns, [paged(16, 96 * 16, sixteen) for _ in range(4)]),
    }


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
    libs = _build_variants()
    cases = _inputs(torch.Generator(device=dev).manual_seed(0), dev)
    refs = {name: plain(*sets[0]) for name, (_, plain, sets) in cases.items()}
    saved = dattn.SPLIT_ROWS, dict(_build._LIBS)
    try:
        for rnd in range(args.rounds):
            for (stages, rows), lib in libs.items():
                _build._LIBS["decode_attention"] = lib
                dattn.SPLIT_ROWS = pattn.SPLIT_ROWS = rows
                parts = []
                for name, (fn, _, sets) in cases.items():
                    err = (fn(*sets[0]) - refs[name]).abs().max().item()
                    ms = _time_ms([lambda a=a: fn(*a) for a in sets])
                    parts.append(f"{name} {ms * 1e3:.2f} us (err {err:.1e})")
                print(f"round {rnd} kStages={stages} kSplitRows={rows}: " + ", ".join(parts), flush=True)
    finally:
        dattn.SPLIT_ROWS = pattn.SPLIT_ROWS = saved[0]
        _build._LIBS.clear()
        _build._LIBS.update(saved[1])


if __name__ == "__main__":
    main()
