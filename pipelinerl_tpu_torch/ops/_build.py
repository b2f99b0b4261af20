"""Build the CUDA kernels of ``csrc/`` with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on first use, for ``sm_90a``, into a shared
library with a plain C interface under ``_build/`` (git-ignored), named by
the hash of its source and of every header in ``csrc/`` (which each source
may include), so an edited source or header never loads a stale library.
Only sources in this package are built. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# name -> [(C function, argtypes)], filled by the op modules
_SIGNATURES: dict[str, list[tuple[str, list]]] = {}
_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


@dataclass
class BuildInfo:
    name: str
    path: Path
    seconds: float  # 0.0 when the library was already built
    ptxas: str  # nvcc's -Xptxas -v report (registers, shared memory, spills)


def declare(name: str, function: str, argtypes: list) -> None:
    """Register the C signature of ``function`` in ``csrc/<name>.cu``; every
    function returns a ``cudaError_t`` as int."""
    _SIGNATURES.setdefault(name, []).append((function, argtypes))


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return nvcc


def nvcc_command(src: Path, out: Path) -> list[str]:
    """nvcc building ``src`` into the shared library ``out``, with the
    headers of ``csrc/`` on the include path (also for a copy of a source
    elsewhere, as the sweeps build)."""
    return [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", str(out), str(src)]


def _target(name: str) -> tuple[Path, Path]:
    src = CSRC_DIR / f"{name}.cu"
    if not src.is_file():
        raise FileNotFoundError(f"no kernel source {src}")
    text = src.read_bytes() + b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha1(text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return src, BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: list[str]) -> list[BuildInfo]:
    """Compile the named sources that are not built yet, all ``nvcc``
    processes started together. Raises if a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    infos = []
    for name in names:
        src, lib = _target(name)
        if lib.exists():
            infos.append(BuildInfo(name, lib, 0.0, ""))
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(nvcc_command(src, tmp), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((name, lib, tmp, proc, time.monotonic()))
    failures = []
    for name, lib, tmp, proc, t0 in jobs:
        log, _ = proc.communicate()
        seconds = time.monotonic() - t0
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, lib)
        infos.append(BuildInfo(name, lib, seconds, log))
    if failures:
        raise RuntimeError("\n".join(failures))
    return infos


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        if name not in _LIBS:
            (info,) = [i for i in build([name]) if i.name == name]
            lib = ctypes.CDLL(str(info.path))
            for function, argtypes in _SIGNATURES.get(name, []):
                fn = getattr(lib, function)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _LIBS[name] = lib
    return _LIBS[name]
