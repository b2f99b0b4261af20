"""Plant known faults in a copy of the CUDA sources and show that
``chip_smoke.py``'s row-relative gate (``OUT_ROW_RTOL``) fails each one,
where the absolute limits pass them.

Run on a machine with an NVIDIA Hopper GPU and nvcc, from the repo's root:

    python -m pipelinerl_tpu_torch.ops.gate_faults

The faults, each at the shape where an output is small:
1. #1's merge drops split 1, at the tir slab (32 slots of 32,776 rows, 129
   splits) with lengths near the allocation;
2. #2's output 1% high past position 4,096 where a block stores its own
   span, at a B 1 L 16,384 prefill;
3. #2's output 1% high where a cluster merges a split span, at a turn of
   128 tokens resumed after 3,968.

The copy is built and measured in a child process; the checkout's sources
are not touched. Prints one JSON line per fault and exits 1 unless the
gate fails every one.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FAULTS = {  # source: [(line as written, line with the fault)]
    "decode_attention.cu": [
        ("      const float e = expf(p[j * rec + g] - mx);",
         "      const float e = j == 1 ? 0.f : expf(p[j * rec + g] - mx);"),
    ],
    "gqa_attention_fwd.cu": [
        ("__floats2bfloat162_rn(o[nd][2 * h] / lsum, o[nd][2 * h + 1] / lsum);",
         "__floats2bfloat162_rn(o[nd][2 * h] / lsum * (r / G >= 4096 ? 1.01f : 1.f), "
         "o[nd][2 * h + 1] / lsum * (r / G >= 4096 ? 1.01f : 1.f));"),
        ("__floats2bfloat162_rn(a.x / l, a.y / l);", "__floats2bfloat162_rn(1.01f * a.x / l, 1.01f * a.y / l);"),
        ("__floats2bfloat162_rn(a.z / l, a.w / l);", "__floats2bfloat162_rn(1.01f * a.z / l, 1.01f * a.w / l);"),
    ],
}


def plant(copy: Path) -> None:
    for name, edits in FAULTS.items():
        path = copy / "pipelinerl_tpu_torch" / "csrc" / name
        text = path.read_text()
        for good, bad in edits:
            if text.count(good) != 1:
                raise SystemExit(f"{name}: the line to break is not there exactly once: {good!r}")
            text = text.replace(good, bad)
        path.write_text(text)


def measure() -> None:
    """In the copy: each faulted kernel against its plain version, as a
    JSON line."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from pipelinerl_tpu_torch.ops import _build
    from pipelinerl_tpu_torch.ops import decode_attention as dattn
    from pipelinerl_tpu_torch.ops import gqa_attention as gattn

    _build.build(cs.SOURCES)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(21)
    H, K, Dh = cs.QWEN05B.num_heads, cs.QWEN05B.num_kv_heads, 64
    S, W, T = 32, 8, 32776
    lens = [int(x) for x in np.random.default_rng(21).integers(T - W - 512, T - W + 1, S)]
    a = cs._decode_inputs(gen, S, H, K, Dh, T, W, lens, W - 1, dev)
    cases = [("#1 merge without split 1, tir slab at full lengths", dattn.decode_attention_staged_ragged(*a),
              dattn.decode_attention_staged_ragged_plain(*a), 1, cs.DECODE_ATOL)]
    for label, (Lq, Lkv) in (("#2 out 1% high past position 4,096, prefill B 1 L 16,384", (16384, 16384)),
                             ("#2 cluster merge 1% high, turn of 128 resumed after 3,968", (128, 4096))):
        a = cs._gqa_inputs(gen, 1, Lq, Lkv, H, K, Dh, 1, dev)
        cases.append((label, gattn.mha_packed_gqa(*a)[0], gattn.mha_packed_gqa_plain_blocked(*a, block=1024)[0], 2,
                      cs.GQA_OUT_ATOL))
    for label, out, ref, row_dims, limit in cases:
        print(json.dumps({"fault": label, "max_abs_err": (out.float() - ref.float()).abs().max().item(),
                          "abs_limit": limit, "row_rel_err": cs.row_rel_err(out, ref, row_dims),
                          "row_rtol": cs.OUT_ROW_RTOL}), flush=True)


def main() -> None:
    with tempfile.TemporaryDirectory() as tmp:
        copy = Path(tmp)
        shutil.copytree(ROOT / "pipelinerl_tpu_torch", copy / "pipelinerl_tpu_torch",
                        ignore=shutil.ignore_patterns("_build", "__pycache__"))
        shutil.copy2(ROOT / "chip_smoke.py", copy)
        plant(copy)
        proc = subprocess.run([sys.executable, "-m", "pipelinerl_tpu_torch.ops.gate_faults", "--measure"],
                              cwd=copy, capture_output=True, text=True, timeout=900)
    rows = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]
    for row in rows:
        print(json.dumps(row))
    caught = proc.returncode == 0 and len(rows) == 3 and all(r["row_rel_err"] > r["row_rtol"] for r in rows)
    print(f"the row-relative gate fails every planted fault: {caught}")
    if not caught:
        print(proc.stderr[-3000:], file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    measure() if sys.argv[1:] == ["--measure"] else main()
