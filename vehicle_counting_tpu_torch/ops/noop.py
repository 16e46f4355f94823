"""Launch-cost probe kernel (K7): `o = x + 1.0` on a small f32 block.

Port of the TPU kernel `benchmarks/micro/noop_launch.py::noop`. The CUDA
kernel `csrc/noop.cu` is reached through `noop_add1` by the same route as
every other kernel of this package (`ctypes` -> C entry -> `<<<>>>` on
PyTorch's current stream), so what a call costs is what a launch costs.
`benchmarks/micro/noop_launch.py` of this package times it.
"""

from __future__ import annotations

import ctypes

import torch

from vehicle_counting_tpu_torch import _build


def noop_add1_plain(x: torch.Tensor) -> torch.Tensor:
    return x + 1.0


_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]


def _entry():
    return _build.entry("noop", "vct_noop_add1", _ARGTYPES)


def noop_add1(x: torch.Tensor) -> torch.Tensor:
    """K7: x + 1.0 for a contiguous f32 tensor.

    CPU tensors take the plain version; CUDA tensors launch the kernel of
    `csrc/noop.cu` (array-equal to the plain version) or raise.
    """
    if x.device.type == "cpu":
        return noop_add1_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"x must be contiguous float32, got {x.dtype}, contiguous={x.is_contiguous()}")
    if x.numel() >= 2 ** 31:
        raise ValueError(f"x has {x.numel()} elements; the kernel indexes with int32")
    out = torch.empty_like(x)
    rc = _entry()(x.data_ptr(), out.data_ptr(), x.numel(), _build.current_stream(x.device))
    _build.check(rc, "noop kernel")
    noop_add1.launches += 1
    return out


noop_add1.launches = 0


def bare_launcher(buf: torch.Tensor):
    """-> a function that launches the same kernel once with n = 0 through
    `ctypes` alone: the entry point, pointer and stream are looked up here,
    so a call is the C call and nothing else (no allocation, no torch op).
    `buf` supplies a valid device pointer and the device whose current
    stream takes the launches. Each call counts as a launch."""
    if buf.device.type != "cuda":
        raise ValueError(f"bare_launcher needs a CUDA tensor, got {buf.device}")
    fn, p = _entry(), buf.data_ptr()
    stream = _build.current_stream(buf.device)

    def launch(_keep=buf):  # the closure keeps the buffer alive while launches may use its pointer
        _build.check(fn(p, p, 0, stream), "noop kernel (n=0)")
        noop_add1.launches += 1

    return launch
