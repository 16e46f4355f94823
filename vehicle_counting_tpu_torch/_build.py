"""Build the hand-written CUDA kernels of `csrc/` and load them with ctypes.

Each `csrc/<name>.cu` has a plain C interface. It is compiled with `nvcc`
at its first use into `build/kernels/` at the repository root (a
directory `.gitignore` lists), keyed by a hash of the source, the headers
it includes from `csrc/` and the flags, so an edited source or header is
rebuilt and an unchanged one is loaded as built. `load_all` starts one
`nvcc` per source at once. `load_prebuilt` registers a library built
elsewhere (a serving artifact's copy) after checking that its key is the
one this checkout's source gives; it needs no `nvcc`.
Nothing here runs at import time: the CPU tests import every module on a
machine without `nvcc`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from typing import Dict, Iterable, Sequence, Tuple, Union

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "build", "kernels")

# --fmad=false: no a*b+c contraction into FMA, so the kernels round exactly
# like their plain PyTorch versions (bit-exactness is their contract)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)

_LIBS: Dict[str, ctypes.CDLL] = {}
_PATHS: Dict[str, str] = {}  # the file each loaded library came from
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


def _sources(src: str, seen=None) -> list:
    """`src` and, recursively, every header it includes from `csrc/`."""
    seen = [] if seen is None else seen
    if src in seen:
        return seen
    seen.append(src)
    with open(src) as f:
        for inc in re.findall(r'^\s*#\s*include\s+"([^"]+)"', f.read(), re.M):
            path = os.path.join(CSRC_DIR, inc)
            if os.path.exists(path):
                _sources(path, seen)
    return seen


def _target(name: str):
    """(source, path of the built library) for `csrc/<name>.cu`."""
    src = os.path.join(CSRC_DIR, name + ".cu")
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources(src):
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    return src, os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def _start(name: str):
    """Start nvcc for `name` unless built; -> (proc, tmp, out, src) or None."""
    src, out = _target(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, tmp, out, src


def _finish(name: str, job) -> None:
    proc, tmp, out, src = job
    stdout, stderr = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{stdout}\n{stderr}")
    BUILD_LOGS[name] = stderr.strip()
    os.replace(tmp, out)


def load_all(names: Iterable[str]) -> None:
    """Compile every missing library of `names` in parallel, then load all."""
    names = list(names)
    with _LOCK:
        jobs = {n: _start(n) for n in names if n not in _LIBS}
        for n, job in jobs.items():
            if job is not None:
                _finish(n, job)
    for n in names:
        load(n)


def load(name: str) -> ctypes.CDLL:
    """Compile (if needed) and load `csrc/<name>.cu` as a shared library."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is not None:
            return lib
        job = _start(name)
        if job is not None:
            _finish(name, job)
        path = _target(name)[1]
        lib = ctypes.CDLL(path)
        _LIBS[name], _PATHS[name] = lib, path
        return lib


def cache_key(name: str) -> str:
    """The key of `csrc/<name>.cu`'s library in this checkout: a hash of the
    source, the headers it includes and the flags (part of its file name)."""
    return os.path.basename(_target(name)[1])[len(f"lib{name}_"):-len(".so")]


def library_path(name: str) -> str:
    """The file `name`'s library was loaded from, or where `load` builds it."""
    return _PATHS.get(name) or _target(name)[1]


def check_prebuilt(name: str, path: str) -> None:
    """Raise unless `path` is named as this checkout builds `csrc/<name>.cu`:
    `lib<name>_<cache_key>.so`, so the same source, headers and flags."""
    want = os.path.basename(_target(name)[1])
    if os.path.basename(path) != want:
        raise ValueError(f"{path}: not the {name} kernel library of this source (its key gives {want})")


def load_prebuilt(name: str, path: str) -> ctypes.CDLL:
    """Register the library at `path` as `csrc/<name>.cu`'s, after
    `check_prebuilt`, without nvcc. A library of that name that is loaded
    already has the same key, so it stays; `library_path` says which file
    runs."""
    check_prebuilt(name, path)
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = os.path.abspath(path)
            lib = ctypes.CDLL(path)
            _LIBS[name], _PATHS[name] = lib, path
        return lib


_ENTRIES: Dict[Tuple[object, str], tuple] = {}


def entry(lib: Union[str, ctypes.CDLL], symbol: str, argtypes: Sequence):
    """The C entry point `symbol` of `lib` (a kernel's name for `load`, or a
    loaded library), returning `int` (a cudaError_t) and taking `argtypes`.
    The function is resolved and its types are set at the first call only;
    later calls return the same object, so a launch pays one dict lookup."""
    key = (lib if isinstance(lib, str) else id(lib), symbol)
    hit = _ENTRIES.get(key)
    if hit is None:
        handle = load(lib) if isinstance(lib, str) else lib
        fn = getattr(handle, symbol)
        fn.restype = ctypes.c_int
        fn.argtypes = list(argtypes)
        hit = _ENTRIES[key] = (fn, handle)  # the handle stays alive with its id
    return hit[0]


def current_stream(device) -> int:
    """The raw handle of PyTorch's current CUDA stream on `device`, for a
    C entry point's `stream` argument. Through the raw getter where this
    PyTorch has it: no Stream object is built on the launch path."""
    import torch

    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None and device.index is not None:
        return raw(device.index)
    return torch.cuda.current_stream(device).cuda_stream


def check(rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")
