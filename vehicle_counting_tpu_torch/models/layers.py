"""Conv building blocks for the detection and ReID models.

Port of `vehicle_counting_tpu/models/layers.py`. The JAX code is NHWC/HWIO;
here the convs run NCHW/OIHW on cuDNN (or oneDNN on the CPU), and the
public helpers that take activations (`conv_block`, `max_pool`,
`upsample2x_nearest`) keep the JAX layout by taking NHWC tensors. The
`*_nchw` forms are what the models run internally. `conv2d` takes JAX's
call with NHWC activations and the port's OIHW weights; JAX's
`dimension_numbers` constant `DN` has no torch counterpart.

Params are plain dicts of tensors: {"w": [cout, cin/groups, kh, kw],
"b": [cout]}, BatchNorm already folded for YOLO (models/convert.py).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


def autopad(k: int, p: Optional[int] = None) -> int:
    """Default 'same-ish' padding: k // 2 unless explicitly given."""
    return k // 2 if p is None else p


def conv_block_nchw(params, x, *, stride=1, padding=None, groups=1, act=True):
    """Fused Conv(+folded BN) + SiLU on NCHW, in the dtype of the weights."""
    w = params["w"]
    y = F.conv2d(x.to(w.dtype), w, params["b"], stride=stride,
                 padding=autopad(w.shape[-1], padding), groups=groups)
    return F.silu(y) if act else y


def conv2d(x, w, *, stride=1, padding=None, groups=1, dtype=None):
    """Plain conv, JAX's call: x [B, H, W, Cin] (NHWC), w the port's OIHW
    [Cout, Cin/groups, kh, kw] -> [B, H', W', Cout] in f32, as JAX's
    `preferred_element_type=float32` gives. Both operands are cast to the
    compute dtype `dtype` (None: the weights')."""
    p = autopad(w.shape[-1], padding)
    dtype = w.dtype if dtype is None else dtype
    y = F.conv2d(x.permute(0, 3, 1, 2).to(dtype), w.to(dtype), stride=stride, padding=p, groups=groups)
    return y.permute(0, 2, 3, 1).float()


def conv_block(params, x, *, stride=1, padding=None, groups=1, act=True, dtype=None):
    """Fused Conv(+folded BN) + SiLU with the JAX layout: x [B, H, W, Cin] ->
    [B, H', W', Cout]. The conv computes in `dtype` (None: the weights'),
    the bias and SiLU in f32, and the result is cast to `dtype` (None: f32),
    as in JAX."""
    y = conv2d(x, params["w"], stride=stride, padding=padding, groups=groups, dtype=dtype)
    y = y + params["b"].float()
    if act:
        y = F.silu(y)
    return y if dtype is None else y.to(dtype)


def max_pool(x, k: int, stride: int = 1, padding: Optional[int] = None):
    """torch MaxPool2d(k, stride, padding) on NHWC."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), k, stride, autopad(k, padding))
    return y.permute(0, 2, 3, 1)


def upsample2x_nearest_nchw(x):
    """Nearest-neighbour 2x upsample (nn.Upsample(2, 'nearest')) on NCHW."""
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


def upsample2x_nearest(x):
    """Nearest-neighbour 2x upsample on NHWC."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def init_conv(gen: torch.Generator, k: int, cin: int, cout: int, groups: int = 1,
              device=None):
    """He-normal conv weights [cout, cin/groups, k, k], zero bias."""
    fan_in = k * k * cin // groups
    w = torch.randn((cout, cin // groups, k, k), generator=gen, dtype=torch.float32)
    return {
        "w": (w * math.sqrt(2.0 / fan_in)).to(device),
        "b": torch.zeros((cout,), dtype=torch.float32, device=device),
    }
