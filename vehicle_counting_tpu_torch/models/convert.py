"""Carry the JAX package's parameter pytrees across to the port.

The JAX models store conv weights HWIO ([kh, kw, cin, cout]); the port's
convs take OIHW ([cout, cin, kh, kw]). Every other leaf (biases, BN
vectors, dense [in, out] matrices) keeps its shape. YOLO params arrive
with conv+BN already folded; ReID params keep BN explicit with separate
running stats. Leaves may be numpy or JAX arrays (anything np.asarray
takes), so this module imports no JAX.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch


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
