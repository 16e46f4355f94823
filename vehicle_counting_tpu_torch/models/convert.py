"""Carry the JAX package's parameter pytrees across to the port.

The JAX models store conv weights HWIO ([kh, kw, cin, cout]); the port's
convs take OIHW ([cout, cin, kh, kw]). Every other leaf (biases, BN
vectors, dense [in, out] matrices) keeps its shape. YOLO params arrive
with conv+BN already folded; ReID params keep BN explicit with separate
running stats. Leaves may be numpy or JAX arrays (anything np.asarray
takes), so this module imports no JAX. The kernels K5 and K6 keep the
JAX HWIO layout (`reid_block64_from_jax`, `conv1_s2_from_jax`).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from vehicle_counting_tpu_torch.models.reid import BN_EPS
from vehicle_counting_tpu_torch.ops.reid_block import fold_bn


def _convert(tree, device, conv_key=None):
    if isinstance(tree, dict):
        return {k: _convert(v, device, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_convert(v, device, conv_key) for v in tree]
    a = np.asarray(tree)
    if conv_key == "w" and a.ndim == 4:
        a = np.transpose(a, (3, 2, 0, 1))  # HWIO -> OIHW
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def yolo_params_from_jax(pytree, device=None) -> Dict[str, Any]:
    """JAX `init_yolov5` / `load_yolov5_weights` pytree -> port params."""
    return _convert(pytree, device)


def reid_params_from_jax(params, stats, device=None) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """JAX `init_reid` / `load_reid_weights` (params, stats) -> port dicts."""
    return _convert(params, device), _convert(stats, device)


def _tensor(a, device):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32))).to(device)


def reid_block64_from_jax(params, stats, device=None) -> Dict[str, torch.Tensor]:
    """One JAX stage-1 BasicBlock (params["layer1_i"], stats["layer1_i"])
    -> operands of `ops/reid_block.py::reid_block64`: w1, w2 HWIO
    [3, 3, 64, 64] as stored, BN folded to a1, b1, a2, b2 [64] f32."""
    out = {"w1": _tensor(params["conv1"]["w"], device), "w2": _tensor(params["conv2"]["w"], device)}
    for i in (1, 2):
        bp, bs = params[f"bn{i}"], stats[f"bn{i}"]
        out[f"a{i}"], out[f"b{i}"] = fold_bn(*(_tensor(v, device) for v in (
            bp["scale"], bp["bias"], bs["mean"], bs["var"])), BN_EPS)
    return out


def conv1_s2_from_jax(params, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """A JAX layer-1 conv {"w": HWIO [3, 3, 32, 64], "b": [64]} -> (w, b)
    for `ops/conv_s2.py::conv1_s2_silu`, which takes HWIO as stored."""
    return _tensor(params["w"], device), _tensor(params["b"], device)
