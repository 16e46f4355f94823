"""The ReID trunk's BatchNorm epilogue (kernel K8): everything between one
convolution and the next in one launch.

Port-only: no TPU kernel stands behind it (XLA fuses the same elementwise
chain on the TPU). `reid_epilogue_plain` is the chain `models/reid.py` ran
eagerly after every convolution of the inference trunk, op for op:

    y = x.float()                          the convolution's raw output
    y = y + pre_bias                       (the stem's conv bias)
    y = (y - mean) * inv * scale + bias    inference BN, inv = rsqrt(var + eps)
    y = residual + y                       (the BasicBlock's shortcut)
    y = relu(y)
    -> (y, y.to(lo)): the f32 result where a later op reads f32 (the
       shortcut, the pools) and the copy in the next convolution's dtype

`csrc/reid_epilogue.cu` computes the same in one pass, bitwise: each step
rounded to f32 in the same order, the outputs in x's memory format (NCHW
or channels-last), so the next convolution sees the layout it saw before.
It takes x in bf16 or f32, f32 BN vectors and residual, and a bf16 copy,
and refuses anything else on the card; CPU tensors take the plain chain
at any dtype (the trainer's f64 reference runs, where the chain promotes).
"""

from __future__ import annotations

import ctypes

import torch

from vehicle_counting_tpu_torch import _build
from vehicle_counting_tpu_torch.ops.weight_cache import cached

_ROW = (1, -1, 1, 1)


def bn_inv(var: torch.Tensor, eps: float) -> torch.Tensor:
    """rsqrt(var + eps), computed by torch as the eager chain does, and kept
    per `var` tensor while it lives and is not changed in place
    (`ops/weight_cache.py`); an inference tensor's is computed per call."""
    return cached(("bn_inv", eps), (var,), lambda: torch.rsqrt(var + eps))


def reid_epilogue_plain(x, mean, inv, scale, bias, pre_bias=None, residual=None, relu=False, f32=True, lo=None):
    """The eager chain (module docstring). Returns (the f32 result or None
    unless `f32`, its copy in dtype `lo` or None where `lo` is None)."""
    y = x.float()
    if pre_bias is not None:
        y = y + pre_bias.view(_ROW)
    y = (y - mean.view(_ROW)) * inv.view(_ROW) * scale.view(_ROW) + bias.view(_ROW)
    if residual is not None:
        y = residual + y
    if relu:
        y = torch.relu(y)
    return (y if f32 else None), (None if lo is None else y.to(lo))


_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 8
             + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
_IN_DTYPES = (torch.float32, torch.bfloat16)


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def _launch(x, mean, inv, scale, bias, pre_bias, residual, relu, f32, lo):
    """Check the operands and launch the kernel on x's device's current stream."""
    if x.dim() != 4 or x.dtype not in _IN_DTYPES:
        raise ValueError(f"x must be [N, C, H, W] float32 or bfloat16, got {tuple(x.shape)} {x.dtype}")
    # the embed's activations are channels-last: tested first
    if x.is_contiguous(memory_format=torch.channels_last):
        channels_last = 1
    elif x.is_contiguous():
        channels_last = 0
    else:
        raise ValueError(f"x must be NCHW or channels-last contiguous, got strides {x.stride()}")
    if lo not in (None, torch.bfloat16) or not (f32 or lo):
        raise ValueError(f"the kernel writes f32 and/or a bfloat16 copy; got f32={f32}, lo={lo}")
    n, c, h, w = x.shape
    idx = x.get_device()
    for v in (mean, inv, scale, bias) if pre_bias is None else (mean, inv, scale, bias, pre_bias):
        if v.dtype is not torch.float32 or v.numel() != c or v.get_device() != idx or not v.is_contiguous():
            raise ValueError(f"BN vectors must be contiguous float32 [{c}] on {x.device}, got {v.dtype} "
                             f"{tuple(v.shape)} on {v.device}")
    if residual is not None and (residual.dtype is not torch.float32 or residual.shape != x.shape
                                 or residual.stride() != x.stride() or residual.get_device() != idx):
        raise ValueError(f"residual must be float32 {tuple(x.shape)} with x's strides {x.stride()} on {x.device}, "
                         f"got {residual.dtype} {tuple(residual.shape)} {residual.stride()} on {residual.device}")
    out32 = torch.empty_like(x, dtype=torch.float32) if f32 else None  # x's strides: dense, so kept
    outlo = torch.empty_like(x, dtype=lo) if lo is not None else None
    rc = _build.entry("reid_epilogue", "vct_reid_epilogue", _ARGTYPES)(
        x.data_ptr(), int(x.dtype == torch.bfloat16), mean.data_ptr(), inv.data_ptr(), scale.data_ptr(),
        bias.data_ptr(), _ptr(pre_bias), _ptr(residual), _ptr(out32), _ptr(outlo), x.numel(), c, h * w,
        channels_last, int(relu), _build.current_stream(x.device))
    _build.check(rc, "reid epilogue kernel")
    return out32, outlo


def reid_epilogue(x, mean, inv, scale, bias, pre_bias=None, residual=None, relu=False, f32=True, lo=None):
    """K8: the BN epilogue of one convolution of the ReID trunk.

    x the convolution's output [N, C, H, W]; mean, inv (`bn_inv`), scale,
    bias and the optional pre_bias [C]; the optional residual like x, f32.
    Returns (f32 result or None, copy in dtype `lo` or None), each in x's
    memory format. CPU tensors take the plain version; CUDA tensors launch
    the kernel of `csrc/reid_epilogue.cu` (bitwise the plain version) or
    raise.
    """
    if not x.is_cuda:
        if x.device.type == "cpu":
            return reid_epilogue_plain(x, mean, inv, scale, bias, pre_bias, residual, relu, f32, lo)
        raise ValueError(f"unsupported device {x.device}")
    out = _launch(x, mean, inv, scale, bias, pre_bias, residual, relu, f32, lo)
    reid_epilogue.launches += 1
    return out


reid_epilogue.launches = 0
