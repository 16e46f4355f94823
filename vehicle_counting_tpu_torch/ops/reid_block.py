"""Fused ReID stage-1 BasicBlock (kernel K5).

Port of the TPU kernel `ops/pallas/reid_block.py::reid_block64_pallas` into
the CUDA kernel `csrc/reid_block.cu`, with the plain version
`reid_block64_plain` beside it:

    out = relu(bn2(conv3x3(h1)) + x),   h1 = relu(bn1(conv3x3(x)))

BN folded to a * v + b (`fold_bn`). Numerics as the TPU kernel's: conv
operands in the compute dtype (x.dtype: bf16 or f32) with f32
accumulation, h1 rounded to the compute dtype (the pad acts as zeros),
y = h2 * a2 + b2 + x in f32, relu, output in x.dtype. Activations are
NCHW [N, 64, 25, 25], the port's ReID layout; weights HWIO [3, 3, 64, 64]
(`hwio` from the port's OIHW, `models/convert.py` from the JAX pytree).
The bf16 kernel runs on the tensor cores and takes its weights packed by
`pack_weights`; the f32 kernel (a parity mode) runs on the CUDA cores and
takes them packed by `pack_weights_f32`. `kernel_weights` keeps each pack
per source tensor (`ops/weight_cache.py`).
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch
import torch.nn.functional as F

from vehicle_counting_tpu_torch import _build
from vehicle_counting_tpu_torch.ops.weight_cache import cached

C = 64
S = 25
_DTYPES = (torch.float32, torch.bfloat16)


def fold_bn(scale, bias, mean, var, eps: float):
    """Inference BN as (a, b) with y = x * a + b, in f32:
    a = rsqrt(var + eps) * scale, b = bias - mean * a."""
    a = torch.rsqrt(var.float() + eps) * scale.float()
    return a, bias.float() - mean.float() * a


def hwio(w_oihw: torch.Tensor) -> torch.Tensor:
    """OIHW conv weights -> the kernel's HWIO [kh, kw, cin, cout], contiguous."""
    return w_oihw.permute(2, 3, 1, 0).contiguous()


_PACK_INDEX: Dict[torch.device, torch.Tensor] = {}


def _pack_index(device: torch.device) -> torch.Tensor:
    """For each element of the packed layout, its flat index in
    torch.stack([w1, w2]) of HWIO weights; built once per device."""
    idx = _PACK_INDEX.get(device)
    if idx is None:
        conv, tap, co, chunk, e = torch.meshgrid(*(torch.arange(n) for n in (2, 9, C, C // 8, 8)), indexing="ij")
        ci = (chunk ^ (co % 8)) * 8 + e
        idx = _PACK_INDEX[device] = (((conv * 9 + tap) * C + ci) * C + co).reshape(-1).to(device)
    return idx


def pack_weights(w1: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """HWIO [3, 3, 64, 64] x 2 -> the bf16 kernel's [2 convs, 9 taps, 64 co,
    64 ci] bf16: one K-major slab per tap, each 128-byte row (one co) in the
    tensor cores' 128-byte swizzle, i.e. the 8 ci of chunk c at chunk
    c ^ (co % 8)."""
    return torch.stack([w1, w2]).reshape(-1)[_pack_index(w1.device)].to(torch.bfloat16).view(2, 9, C, C)


def pack_weights_f32(w1: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """HWIO [3, 3, 64, 64] x 2 -> the f32 kernel's [2 convs, 64 ci, 9 taps,
    64 co] f32: every 8 input channels are one contiguous chunk of all 9
    taps, which the kernel streams into shared memory by one copy."""
    return torch.stack([w1, w2]).permute(0, 3, 1, 2, 4).float().contiguous().view(2, C, 9, C)


def kernel_weights(w1: torch.Tensor, w2: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Both convs' weights as the kernel of `dtype` takes them, kept per
    (w1, w2) while those tensors live and are not changed in place."""
    pack = pack_weights if dtype == torch.bfloat16 else pack_weights_f32
    return cached(("reid_block", dtype), (w1, w2), lambda: pack(w1, w2))


def _conv(v: torch.Tensor, w_hwio: torch.Tensor) -> torch.Tensor:
    """3x3 pad-1 conv of compute-dtype operands, accumulated in f32."""
    return F.conv2d(v.float(), w_hwio.to(v.dtype).float().permute(3, 2, 0, 1), padding=1)


def reid_block64_plain(x, w1, w2, a1, b1, a2, b2):
    """Plain version of K5 (F.conv2d in f32 on the compute-dtype values,
    so TF32 must be off for it on the card)."""
    row = (1, -1, 1, 1)
    h1 = torch.relu(_conv(x, w1) * a1.view(row) + b1.view(row)).to(x.dtype)
    y = _conv(h1, w2) * a2.view(row) + b2.view(row) + x.float()
    return torch.relu(y).to(x.dtype)


_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def _launch_kernel(x, wk, ab):
    """The C entry point on checked operands: x contiguous and 16-byte
    aligned, wk both convs' packed weights (`kernel_weights`), ab [4, 64]
    f32 rows a1, b1, a2, b2."""
    out = torch.empty_like(x)
    fn = _build.entry("reid_block", "vct_reid_block64", _ARGTYPES)
    rc = fn(x.data_ptr(), wk.data_ptr(), ab.data_ptr(), out.data_ptr(), x.shape[0], int(x.dtype == torch.bfloat16),
            _build.current_stream(x.device))
    _build.check(rc, "reid block kernel")
    return out


def _launch(x, w1, w2, a1, b1, a2, b2):
    """Check the operands, bring them into the kernel's form and launch it."""
    if x.dim() != 4 or tuple(x.shape[1:]) != (C, S, S):
        raise ValueError(f"x must be [N, {C}, {S}, {S}], got {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    for name, w in (("w1", w1), ("w2", w2)):
        if tuple(w.shape) != (3, 3, C, C) or w.device != x.device:
            raise ValueError(f"{name} must be HWIO [3, 3, {C}, {C}] on {x.device}, got {tuple(w.shape)} on {w.device}")
    ab = torch.stack([a1, b1, a2, b2]).float().contiguous()
    if ab.shape != (4, C) or ab.device != x.device:
        raise ValueError(f"a1, b1, a2, b2 must be [{C}] on {x.device}")
    x = x.contiguous()
    if x.data_ptr() % 16:  # the kernels copy crops 16 bytes at a time
        x = x.clone()
    return _launch_kernel(x, kernel_weights(w1, w2, x.dtype), ab)


def reid_block64(x, w1, w2, a1, b1, a2, b2):
    """K5: relu(bn2(conv2(relu(bn1(conv1(x))))) + x) for x [N, 64, 25, 25].

    w1, w2 HWIO [3, 3, 64, 64]; a1, b1, a2, b2 [64] folded BN (`fold_bn`).
    CPU tensors take the plain version; CUDA tensors launch the kernel of
    `csrc/reid_block.cu` or raise.
    """
    if x.device.type == "cpu":
        return reid_block64_plain(x, w1, w2, a1, b1, a2, b2)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    out = _launch(x, w1, w2, a1, b1, a2, b2)
    reid_block64.launches += 1
    return out


reid_block64.launches = 0
