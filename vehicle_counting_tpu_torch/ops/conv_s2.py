"""YOLO layer 1 as one kernel: conv3x3 stride 2 (32 -> 64) + bias + SiLU (K6).

Port of the TPU kernel `ops/pallas/conv_s2.py::conv1_s2_silu_pallas` into
the CUDA kernel `csrc/conv_s2.cu`, with the plain version
`conv1_s2_silu_plain` beside it. Stand-alone, as in the JAX package: the
detector does not call it (its layer 1 stays `models/layers.py::conv_block`).

Contract: x [B, H, W, 32] (the JAX layout, NHWC), w HWIO [3, 3, 32, 64],
b [64]; H % 32 == 0 and W % 64 == 0. Conv operands in x.dtype (bf16 or
f32) accumulated in f32, bias and SiLU in f32, output [B, H/2, W/2, 64]
in x.dtype. The bf16 kernel runs on the tensor cores and takes its weights
packed by `pack_conv1_weights`, kept per source tensor
(`ops/weight_cache.py`); the f32 kernel (a parity mode on the CUDA cores)
takes HWIO.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch
import torch.nn.functional as F

from vehicle_counting_tpu_torch import _build
from vehicle_counting_tpu_torch.ops.weight_cache import cached

CIN = 32
COUT = 64


def _check_shapes(x, w):
    b, h, wd, cin = x.shape
    if cin != CIN or tuple(w.shape) != (3, 3, CIN, COUT):
        raise ValueError(f"unsupported conv shape {tuple(x.shape)} / {tuple(w.shape)}")
    if h % 32 != 0 or wd % 64 != 0:
        raise ValueError(f"needs H%32==0 and W%64==0, got {h}x{wd}")


def conv1_s2_silu_plain(x, w, b):
    """Plain version of K6 (F.conv2d in f32 on the compute-dtype values,
    so TF32 must be off for it on the card)."""
    _check_shapes(x, w)
    xf = x.permute(0, 3, 1, 2).float()
    wf = w.to(x.dtype).float().permute(3, 2, 0, 1)
    y = F.conv2d(xf, wf, stride=2, padding=1) + b.float().view(1, -1, 1, 1)
    return F.silu(y).to(x.dtype).permute(0, 2, 3, 1).contiguous()


N_SLABS = 5  # the 9 taps in pairs; the tenth half is zeros

_PACK_INDEX: Dict[torch.device, torch.Tensor] = {}


def _pack_index(device: torch.device) -> torch.Tensor:
    """For each element of the packed layout, its flat index in the HWIO
    weights with one zero appended (index 9 * 32 * 64: the tenth tap);
    built once per device."""
    idx = _PACK_INDEX.get(device)
    if idx is None:
        slab, co, chunk, e = torch.meshgrid(*(torch.arange(n) for n in (N_SLABS, COUT, 8, 8)), indexing="ij")
        k = (chunk ^ (co % 8)) * 8 + e
        tap, ci = 2 * slab + k // CIN, k % CIN
        flat = torch.where(tap < 9, (tap * CIN + ci) * COUT + co, 9 * CIN * COUT)
        idx = _PACK_INDEX[device] = flat.reshape(-1).to(device)
    return idx


def pack_conv1_weights(w: torch.Tensor) -> torch.Tensor:
    """HWIO [3, 3, 32, 64] -> the bf16 kernel's [5 slabs, 64 co, 64 k] bf16:
    slab s holds taps 2s and 2s + 1 K-major (k = (tap % 2) * 32 + ci; the
    tenth tap is zeros), each 128-byte row (one co) in the tensor cores'
    128-byte swizzle, i.e. the 8 k of chunk c at chunk c ^ (co % 8)."""
    flat = torch.cat([w.reshape(-1), w.new_zeros(1)])
    return flat[_pack_index(w.device)].to(torch.bfloat16).view(N_SLABS, COUT, 64)


def kernel_weights(w: torch.Tensor) -> torch.Tensor:
    """`pack_conv1_weights(w)`, kept while `w` lives and is not changed in place."""
    return cached("conv_s2", (w,), lambda: pack_conv1_weights(w))


_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def _launch_kernel(x, wk, bias):
    """The C entry point on checked operands: x contiguous (16-byte aligned
    for bf16), wk the weights as the kernel takes them (packed for bf16,
    HWIO f32 otherwise), bias f32."""
    bsz, h, wd, _ = x.shape
    out = torch.empty((bsz, h // 2, wd // 2, COUT), dtype=x.dtype, device=x.device)
    fn = _build.entry("conv_s2", "vct_conv1_s2_silu", _ARGTYPES)
    rc = fn(x.data_ptr(), wk.data_ptr(), bias.data_ptr(), out.data_ptr(), bsz, h, wd,
            int(x.dtype == torch.bfloat16), _build.current_stream(x.device))
    _build.check(rc, "layer-1 conv kernel")
    return out


def _launch(x, w, b):
    """Check the operands, bring them into the kernel's form and launch it."""
    _check_shapes(x, w)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    if w.device != x.device or b.device != x.device or tuple(b.shape) != (COUT,):
        raise ValueError(f"w and b [{COUT}] must be on {x.device}")
    x = x.contiguous()
    if x.dtype == torch.bfloat16:
        w = kernel_weights(w)
        if x.data_ptr() % 16:  # the kernel copies 16 bytes at a time
            x = x.clone()
    else:
        w = w.float().contiguous()
    return _launch_kernel(x, w, b.float().contiguous())


def conv1_s2_silu(x, w, b):
    """K6: silu(conv3x3_s2_p1(x, w) + b) -> [B, H/2, W/2, 64] in x.dtype.

    CPU tensors take the plain version; CUDA tensors launch the kernel of
    `csrc/conv_s2.cu` or raise.
    """
    if x.device.type == "cpu":
        return conv1_s2_silu_plain(x, w, b)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    out = _launch(x, w, b)
    conv1_s2_silu.launches += 1
    return out


conv1_s2_silu.launches = 0
