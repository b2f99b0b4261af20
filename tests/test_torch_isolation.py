"""The port imports nothing of JAX or of the JAX package, nor the
``safetensors``, ``tokenizers``, ``transformers`` and ``regex`` packages
(the H100 host has none of them): every module of ``pipelinerl_tpu_torch``
and ``chip_smoke`` imports in a process that refuses all of them, and the
port's tokenizer reads the committed fixture there; ``chip_smoke.main``
raises where there is no CUDA card."""

import subprocess
import sys
import textwrap
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]

CHILD = textwrap.dedent(
    """
    import importlib, pkgutil, sys

    REFUSED = ("jax", "jaxlib", "pipelinerl_tpu", "safetensors", "tokenizers", "transformers", "regex")

    class Refuse:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in REFUSED:
                raise ImportError(f"the port must not import {name}")
            return None

    sys.meta_path.insert(0, Refuse())
    import pipelinerl_tpu_torch
    names = ["chip_smoke"]
    for m in pkgutil.walk_packages(pipelinerl_tpu_torch.__path__, "pipelinerl_tpu_torch."):
        names.append(m.name)
    for name in names:
        importlib.import_module(name)
    from pipelinerl_tpu_torch.models.hf_tokenizer import HFTokenizer
    tok = HFTokenizer("pipelinerl_tpu_torch/fixtures/hf_tokenizer")
    ids = tok.apply_chat_template([{"role": "user", "content": "say x"}], add_generation_prompt=True)
    assert tok.decode(ids) == "<|im_start|>user\\nsay x<|im_end|>\\n<|im_start|>assistant\\n"
    bad = [m for m in sys.modules if m.split(".")[0] in REFUSED]
    assert not bad, bad
    print("IMPORTED", len(names))
    import chip_smoke, torch
    if not torch.cuda.is_available():
        try:
            chip_smoke.main()
        except RuntimeError as e:
            print("RAISED", e)
    """
)


def test_port_imports_without_jax_and_chip_smoke_needs_a_card():
    proc = subprocess.run(
        [sys.executable, "-c", CHILD], cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    n = int(proc.stdout.split("IMPORTED ")[1].split()[0])
    assert n >= 34  # every module of the package (serving, paged KV, training), and chip_smoke
    if not torch.cuda.is_available():
        assert "RAISED no CUDA device" in proc.stdout, proc.stdout
        assert '"ok"' not in proc.stdout


def test_chip_smoke_fails_outside_the_repo(tmp_path):
    """Alone in a directory, the script cannot find the port and fails."""
    (tmp_path / "chip_smoke.py").write_text((ROOT / "chip_smoke.py").read_text())
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True, text=True, timeout=120,
        env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)},
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
