"""Build the hand-written CUDA kernels of `csrc/` and load them with ctypes.

Each `csrc/<name>.cu` has a plain C interface. It is compiled with `nvcc`
at its first use into `build/kernels/` at the repository root (a
directory `.gitignore` lists), keyed by a hash of the source and flags, so
an edited source is rebuilt and an unchanged one is loaded as built.
Nothing here runs at import time: the CPU tests import every module on a
machine without `nvcc`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "build", "kernels")

# --fmad=false: no a*b+c contraction into FMA, so the kernels round exactly
# like their plain PyTorch versions (bit-exactness is their contract)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)

_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_LOGS: Dict[str, str] = {}  # ptxas register/shared-memory report per kernel
_LOCK = threading.Lock()


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (
        os.path.join(cuda_home, "bin", "nvcc") if cuda_home else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def load(name: str) -> ctypes.CDLL:
    """Compile (if needed) and load `csrc/<name>.cu` as a shared library."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is not None:
            return lib
        src = os.path.join(CSRC_DIR, name + ".cu")
        with open(src, "rb") as f:
            digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        out = os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")
        if not os.path.exists(out):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{out}.{os.getpid()}.tmp"
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                capture_output=True, text=True,
            )
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}\n{proc.stderr}")
            BUILD_LOGS[name] = proc.stderr.strip()
            os.replace(tmp, out)
        lib = ctypes.CDLL(out)
        _LIBS[name] = lib
        return lib


def check(rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")
