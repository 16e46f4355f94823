"""Parameter trees of the port: from the JAX package's pytrees, and from
PyTorch checkpoints on disk.

From JAX pytrees (`*_from_jax`, used by the tests and the smoke test):

The JAX models store conv weights HWIO ([kh, kw, cin, cout]); the port's
convs take OIHW ([cout, cin, kh, kw]). Every other leaf (biases, BN
vectors, dense [in, out] matrices) keeps its shape. YOLO params arrive
with conv+BN already folded; ReID params keep BN explicit with separate
running stats. Leaves may be numpy or JAX arrays (anything np.asarray
takes), so this module imports no JAX. The kernels K5 and K6 keep the
JAX HWIO layout (`reid_block64_from_jax`, `conv1_s2_from_jax`).

From checkpoints (`load_yolov5_weights`; the ReID loader is
`models/reid.py::load_reid_weights`): the reference consumes
  * ultralytics yolov5{s,m,l,x} v6.0 `.pt`, a pickled DetectionModel;
  * the ReID `ckpt.t7` with a plain `net_dict` state dict.
Every BatchNorm of the detector is folded into its conv at load time, in
float64 in numpy and stored float32, in the same order of operations as
the JAX package's converter, so the two trees are bitwise equal; weights
stay OIHW. Unpickling an ultralytics checkpoint normally needs the
ultralytics package; the extractor below walks the pickled module tree
with stub classes instead.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional, Tuple

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
    """JAX `init_reid` / `load_reid_weights` (params, stats) -> port dicts,
    the classifier head (fc1 + its BN stats, fc2) included where JAX has it."""
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


# ---------------------------------------------------------------------------
# checkpoints on disk
# ---------------------------------------------------------------------------

def _to_tensors(tree, device):
    if isinstance(tree, dict):
        return {k: _to_tensors(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_tensors(v, device) for v in tree]
    return torch.from_numpy(np.ascontiguousarray(tree)).to(device)


BN_EPS_DEFAULT = 1e-3  # ultralytics BatchNorm2d eps


# ---------------------------------------------------------------------------
# conv + BN fusion
# ---------------------------------------------------------------------------

def fuse_conv_bn(
    conv_w: np.ndarray,
    bn_gamma: np.ndarray,
    bn_beta: np.ndarray,
    bn_mean: np.ndarray,
    bn_var: np.ndarray,
    eps: float = BN_EPS_DEFAULT,
    conv_b: Optional[np.ndarray] = None,
):
    """Fold BN into a conv. conv_w is OIHW and stays OIHW; returns (w, b).

    y = gamma * (conv(x) + b - mean) / sqrt(var + eps) + beta
      = conv(x) * (gamma/std) + (b - mean) * (gamma/std) + beta
    """
    w = conv_w.astype(np.float64)
    scale = bn_gamma.astype(np.float64) / np.sqrt(bn_var.astype(np.float64) + eps)
    w = w * scale[:, None, None, None]
    b0 = np.zeros(w.shape[0]) if conv_b is None else conv_b.astype(np.float64)
    b = (b0 - bn_mean.astype(np.float64)) * scale + bn_beta.astype(np.float64)
    return w.astype(np.float32), b.astype(np.float32)


def oihw_to_hwio(w: np.ndarray) -> np.ndarray:
    """Torch's OIHW conv weights -> JAX's HWIO, in numpy (the layout the
    kernels K5 and K6 take)."""
    return np.transpose(w, (2, 3, 1, 0))


# ---------------------------------------------------------------------------
# tolerant torch-checkpoint loading (no ultralytics import required)
# ---------------------------------------------------------------------------

class _Stub:
    """Stands in for any unimportable class during unpickling."""

    def __init__(self, *args, **kwargs):
        self._args = args

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        else:
            self.__dict__["_state"] = state

    def __call__(self, *args, **kwargs):  # some reduces call the class
        return self


def load_torch_checkpoint(path: str) -> Any:
    """torch.load that tolerates missing source packages (e.g. ultralytics).

    Uses torch's zip/storage machinery but swaps the unpickler's class lookup
    for stub types, so arbitrary model objects load as attribute trees.
    """
    try:
        return torch.load(path, map_location="cpu", weights_only=False)
    except (ModuleNotFoundError, AttributeError):
        pass

    import pickle as _p

    class _TolerantPickleModule:
        Unpickler = None  # set below
        loads = staticmethod(_p.loads)

        @staticmethod
        def load(f, **kw):
            return _TolerantPickleModule.Unpickler(f, **kw).load()

    class TolerantUnpickler(_p.Unpickler):
        def find_class(self, module, name):
            try:
                return super().find_class(module, name)
            except (ModuleNotFoundError, ImportError, AttributeError):
                return type(name, (_Stub,), {"__module__": module})

    _TolerantPickleModule.Unpickler = TolerantUnpickler
    return torch.load(
        path, map_location="cpu", pickle_module=_TolerantPickleModule, weights_only=False
    )


def module_tree_to_state_dict(obj: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    """Walk a (possibly stubbed) torch Module tree into {name: ndarray}."""

    out: Dict[str, np.ndarray] = {}

    def visit(node, pfx):
        d = getattr(node, "__dict__", None)
        if d is None:
            return
        for store in ("_parameters", "_buffers"):
            for k, v in (d.get(store) or {}).items():
                if v is None:
                    continue
                t = v.detach() if isinstance(v, torch.Tensor) else v
                if isinstance(t, torch.Tensor):
                    out[pfx + k] = t.to(torch.float32).cpu().numpy()
        for k, child in (d.get("_modules") or {}).items():
            visit(child, f"{pfx}{k}.")

    visit(obj, prefix)
    return out


def extract_state_dict(ckpt: Any) -> Dict[str, np.ndarray]:
    """Normalize any supported checkpoint object to {name: np.ndarray}."""

    if isinstance(ckpt, Mapping):
        for key in ("net_dict", "state_dict", "model_state_dict"):
            if key in ckpt:
                return extract_state_dict(ckpt[key])
        if "model" in ckpt and not isinstance(ckpt["model"], (np.ndarray,)):
            inner = ckpt["model"]
            if isinstance(inner, Mapping):
                return extract_state_dict(inner)
            # module object (real or stubbed)
            sd = module_tree_to_state_dict(inner)
            if sd:
                return sd
        # plain state dict
        out = {}
        for k, v in ckpt.items():
            if isinstance(v, torch.Tensor):
                out[k] = v.detach().to(torch.float32).cpu().numpy()
            elif isinstance(v, np.ndarray):
                out[k] = v.astype(np.float32)
        if out:
            return out
        raise ValueError(f"unrecognized checkpoint mapping keys: {list(ckpt)[:8]}")
    # bare module
    sd = module_tree_to_state_dict(ckpt)
    if hasattr(ckpt, "state_dict") and not isinstance(ckpt, _Stub):
        try:
            return {k: v.detach().to(torch.float32).cpu().numpy() for k, v in ckpt.state_dict().items()}
        except Exception:
            pass
    if sd:
        return sd
    raise ValueError(f"cannot extract a state dict from {type(ckpt)!r}")


# ---------------------------------------------------------------------------
# YOLOv5 name-mapped conversion
# ---------------------------------------------------------------------------

def _strip_prefix(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Strip leading 'model.' prefixes until keys start with a layer index."""
    out = sd
    for _ in range(3):
        if all(re.match(r"^\d+\.", k) for k in out):
            return out
        if all(k.startswith("model.") for k in out):
            out = {k[len("model."):]: v for k, v in out.items()}
        else:
            break
    if not all(re.match(r"^\d+\.", k) for k in out):
        raise ValueError(f"unexpected yolov5 key format, e.g. {next(iter(out))!r}")
    return out


def _fused_conv(sd: Dict[str, np.ndarray], base: str) -> Dict[str, np.ndarray]:
    """Convert '<base>.conv.*' + '<base>.bn.*' into fused {'w','b'}."""
    w, b = fuse_conv_bn(
        sd[f"{base}.conv.weight"],
        sd[f"{base}.bn.weight"],
        sd[f"{base}.bn.bias"],
        sd[f"{base}.bn.running_mean"],
        sd[f"{base}.bn.running_var"],
        eps=BN_EPS_DEFAULT,
        conv_b=sd.get(f"{base}.conv.bias"),
    )
    return {"w": w, "b": b}


def _c3_params(sd, i: int) -> Dict[str, Any]:
    n = 0
    while f"{i}.m.{n}.cv1.conv.weight" in sd:
        n += 1
    return {
        "cv1": _fused_conv(sd, f"{i}.cv1"),
        "cv2": _fused_conv(sd, f"{i}.cv2"),
        "cv3": _fused_conv(sd, f"{i}.cv3"),
        "m": [
            {
                "cv1": _fused_conv(sd, f"{i}.m.{j}.cv1"),
                "cv2": _fused_conv(sd, f"{i}.m.{j}.cv2"),
            }
            for j in range(n)
        ],
    }


# the P5 graph's conv and C3 layers (the JAX package's names; the converter
# reads each layer's module from the checkpoint's names, P5 or P6)
CONV_LAYERS = (0, 1, 3, 5, 7, 10, 14, 18, 21)
C3_LAYERS = (2, 4, 6, 8, 13, 17, 20, 23)


def _detect_layer(sd: Dict[str, np.ndarray]) -> int:
    """The Detect layer's index: the last layer of the checkpoint (24 for
    P5, 33 for P6)."""
    return max(int(k.split(".", 1)[0]) for k in sd)


def yolov5_state_dict_to_pytree(state_dict: Dict[str, np.ndarray], device=None) -> Dict[str, Any]:
    """Map an ultralytics v6.0 DetectionModel state dict, P5 or P6, onto the
    parameter tree of models/yolo.py (conv+BN folded, weights OIHW, f32
    tensors). Each layer is the module its names show (a C3 has `cv3`,
    SPPF `cv1` alone, a Conv `conv`); the last layer is Detect."""
    sd = _strip_prefix(dict(state_dict))
    d = _detect_layer(sd)
    layers: Dict[str, Any] = {}
    for i in sorted({int(k.split(".", 1)[0]) for k in sd} - {d}):
        if f"{i}.cv3.conv.weight" in sd:
            layers[str(i)] = _c3_params(sd, i)
        elif f"{i}.cv1.conv.weight" in sd:
            layers[str(i)] = {"cv1": _fused_conv(sd, f"{i}.cv1"), "cv2": _fused_conv(sd, f"{i}.cv2")}
        else:
            layers[str(i)] = _fused_conv(sd, str(i))
    heads = []
    while f"{d}.m.{len(heads)}.weight" in sd:
        j = len(heads)
        heads.append({"w": sd[f"{d}.m.{j}.weight"].astype(np.float32), "b": sd[f"{d}.m.{j}.bias"].astype(np.float32)})
    layers[str(d)] = {"m": heads}
    return _to_tensors(layers, device)


def load_yolov5_weights(path: str, device=None) -> Dict[str, Any]:
    """Full path: .pt/.npz on disk -> fused parameter tree on `device`."""
    if path.endswith(".npz"):
        data = np.load(path)
        sd = {k: data[k] for k in data.files}
        return yolov5_state_dict_to_pytree(sd, device)
    ckpt = load_torch_checkpoint(path)
    return yolov5_state_dict_to_pytree(extract_state_dict(ckpt), device)


def checkpoint_anchors(state_dict: Dict[str, np.ndarray]):
    """Anchors stored in the ckpt ('<detect>.anchors': [nl, na, 2] in units
    of each scale's stride), in pixels."""
    sd = _strip_prefix(dict(state_dict))
    key = f"{_detect_layer(sd)}.anchors"
    if key in sd:
        anc = sd[key]  # per-grid units; multiply by stride for pixels
        from vehicle_counting_tpu_torch.models.yolo import P6_STRIDES, STRIDES

        strides = P6_STRIDES if anc.shape[0] == len(P6_STRIDES) else STRIDES
        return tuple(
            tuple(tuple(float(v) for v in a) for a in (anc[i] * strides[i]))
            for i in range(anc.shape[0])
        )
    return None
