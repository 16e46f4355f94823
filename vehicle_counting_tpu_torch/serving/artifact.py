"""Serving artifacts: a step of the port as code, built kernels and weights.

Port of `vehicle_counting_tpu/serving/artifact.py`. The JAX package ships a
step as serialized StableHLO (`jax.export`): the whole traced program,
Pallas kernels included, with a versioned calling convention, which a
later jax runs without the source that built it. `torch.export` cannot
carry this port's step: its kernels are `ctypes` launches
(`_build.py::load`), the tracker replays a CUDA graph
(`tracking/graph.py::FrameRunner`) and the embed reads a count back to
the host (`tracking/deepsort.py::_embed_compacted_chunks`). So an exported
function here is code plus built kernels:

    manifest.json        format / package / torch / CUDA versions, the card
                         at export (`utils/device.py::card_line`),
                         `source_sha256` over the port's `.py` files and
                         `csrc/*.cu` / `*.cuh`, per-function entries (file,
                         sha256, platform, input specs, device count, the
                         kernel libraries its routes launch), per-kernel
                         entries (file, sha256, cache key), the static
                         config (geometry, thresholds, DeepSortParams /
                         TrackerParams / YoloConfig fields) and which
                         kernel routes are in (`_kernel_modes`)
    <name>.json          one exported function: the port's entry point by
                         qualified name, its static keyword arguments, the
                         shapes and dtypes of its positional inputs, the
                         device count
    kernels/lib<name>_<key>.so   the kernel libraries the steps launch, as
                         `_build.py` built them (a card export only)
    weights.npz          optional: the weights, path-encoded, no pickle

Exported calling conventions (the JAX artifact's):

    pipeline_step(yolo_params, reid_params, reid_stats, states, frames,
                  frame_valid, class_lut) -> (new_states, det, track_outs)
    detect_step(yolo_params, yuv) -> det
    multicam_step(yolo_params, reid_params, reid_stats, class_lut, states,
                  frames, frame_valid) -> (new_states, track_outs)
    framedp_step(yolo_params, reid_params, reid_stats, class_lut, states,
                 frames, frame_valid) -> (new_states, det, track_outs)

What this gives: `ServingArtifact.load` checks every file's sha256 and the
format version, refuses a package whose source differs from the exporter's
(naming both digests), and registers the artifact's own kernel libraries
(`_build.py::load_prebuilt`), so a serving host needs no `nvcc`; the
static config, the weights and the input shapes come from the artifact,
and a call with other shapes, dtypes or devices raises. What it does not
give, where StableHLO does: the artifact runs only on the port source
revision that exported it (the same `source_sha256`), with a PyTorch that
runs that source; it freezes the kernels and the configuration, not the
program. A card artifact raises on a host without a card; a CPU artifact
records no kernels and runs the plain versions.

On the card `pipeline_step` returns, as the live step does, the frame
runner's own state, which the next call moves on: `bound_pipeline_step`
hands out clones, and a caller that keeps outputs of the raw steps across
calls clones them.
"""

from __future__ import annotations

import dataclasses
import functools
import glob
import hashlib
import importlib
import json
import os
import shutil
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from vehicle_counting_tpu_torch import __version__
from vehicle_counting_tpu_torch.utils.device import on_device

MANIFEST_NAME = "manifest.json"
WEIGHTS_NAME = "weights.npz"
KERNELS_DIR = "kernels"
FORMAT_VERSION = 1
PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# path-encoded flat-tree <-> npz (weights bundling without pickle)
# ---------------------------------------------------------------------------


def _leaf_to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """(an npz-able array, the dtype name to restore): bf16 travels as its
    int16 bit pattern, which numpy can hold."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        return t.numpy(), str(t.dtype).replace("torch.", "")
    a = np.asarray(leaf)
    return a, a.dtype.name


def _leaf_from_numpy(a: np.ndarray, dtype: Optional[str]) -> torch.Tensor:
    if dtype == "bfloat16" or a.dtype.name == "bfloat16" or (a.dtype.kind == "V" and a.dtype.itemsize == 2):
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def _encode_paths(tree) -> Tuple[Dict[str, np.ndarray], List[List[list]], List[str]]:
    """Flatten a dict / list / tuple tree of tensors (or arrays) to npz-able
    arrays, JSON paths (the JAX package's encoding: ["d", key] per dict
    level, ["s", index] per sequence level, dict keys in sorted order as
    jax flattens them) and the leaves' dtype names."""
    arrays: Dict[str, np.ndarray] = {}
    paths: List[List[list]] = []
    dtypes: List[str] = []

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                if not isinstance(k, str):
                    raise TypeError(f"non-str dict key in params tree: {k!r}")
                walk(node[k], path + [["d", k]])
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + [["s", i]])
        else:
            arrays[f"a{len(paths)}"], dtype = _leaf_to_numpy(node)
            paths.append(path)
            dtypes.append(dtype)

    walk(tree, [])
    return arrays, paths, dtypes


def _decode_paths(paths: List[List[list]], leaves: List[Any]):
    """Rebuild the nested dict / list tree from encoded paths (the exact
    inverse of `_encode_paths` for trees of dicts, lists and leaves)."""
    if len(paths) == 1 and not paths[0]:
        return leaves[0]
    kind = paths[0][0][0]
    if not all(p and p[0][0] == kind for p in paths):
        raise ValueError("ragged tree paths in the weights bundle")
    groups: Dict[Any, Tuple[list, list]] = {}
    for p, leaf in zip(paths, leaves):
        sub = groups.setdefault(p[0][1], ([], []))
        sub[0].append(p[1:])
        sub[1].append(leaf)
    if kind == "d":
        return {k: _decode_paths(*g) for k, g in groups.items()}
    idxs = sorted(groups)
    if idxs != list(range(len(idxs))):
        raise ValueError(f"sequence holes in the weights bundle: {idxs}")
    return [_decode_paths(*groups[i]) for i in idxs]


def save_weights_bundle(path: str, trees: Dict[str, Any]) -> None:
    """Bundle named param trees ({'yolo': ..., 'reid': ..., 'reid_stats':
    ...}) into one npz plus a JSON structure key (no pickle anywhere). The
    JAX package's format, with each leaf's dtype name added."""
    arrays: Dict[str, np.ndarray] = {}
    meta: Dict[str, Any] = {}
    for name, tree in trees.items():
        arrs, paths, dtypes = _encode_paths(tree)
        base = len(arrays)
        for i in range(len(paths)):
            arrays[f"a{base + i}"] = arrs[f"a{i}"]
        meta[name] = {"first": base, "count": len(paths), "paths": paths, "dtypes": dtypes}
    arrays["__structure__"] = np.frombuffer(json.dumps(meta).encode("utf-8"), dtype=np.uint8).copy()
    np.savez(path, **arrays)


def load_weights_bundle(path: str) -> Dict[str, Any]:
    """Inverse of `save_weights_bundle`: trees of CPU tensors. Reads the
    JAX package's bundles too (their trees are the JAX layout: convert
    them with `models/convert.py`)."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["__structure__"]).decode("utf-8"))
        out = {}
        for name, m in meta.items():
            dtypes = m.get("dtypes") or [None] * m["count"]
            leaves = [_leaf_from_numpy(z[f"a{m['first'] + i}"], dtypes[i]) for i in range(m["count"])]
            out[name] = _decode_paths(m["paths"], leaves)
    return out


# ---------------------------------------------------------------------------
# export
# ---------------------------------------------------------------------------


def _leaves(tree) -> List[torch.Tensor]:
    """The tensor leaves of a dict / list / tuple tree, dict keys sorted."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _specs(tree) -> List[list]:
    """[shape, dtype name] of every leaf, in `_leaves` order."""
    return [[list(t.shape), _dtype_name(t.dtype)] for t in _leaves(tree)]


def _platform(tree, platforms: Optional[Sequence[str]]) -> str:
    """The device type the weights live on, the platform of the export."""
    platform = _leaves(tree)[0].device.type
    if platforms is not None and list(platforms) != [platform]:
        raise ValueError(f"the weights live on '{platform}': this package exports for the weights' device "
                         f"type only, not {list(platforms)}")
    return platform


def serving_frames_shape(
    frames_format: str,
    batch: int,
    src_hw: Tuple[int, int],
    image_size: Tuple[int, int],
    content_only: bool = True,
) -> Tuple[int, ...]:
    """The [B, ...] uint8 frames shape a serving host must upload, matching
    the pipeline's producer for each frames_format."""
    from vehicle_counting_tpu_torch.ops.letterbox import content_rows, content_upload_exact

    dh, dw = image_size
    if frames_format == "raw_rgb":
        return (batch, src_hw[0], src_hw[1], 3)
    if frames_format == "letterboxed_rgb":
        return (batch, dh, dw, 3)
    if frames_format == "letterboxed_yuv420":
        if content_only and content_upload_exact(src_hw, image_size):
            _, ch = content_rows(src_hw, image_size)
            return (batch, ch * 3 // 2, dw)
        return (batch, dh * 3 // 2, dw)
    raise ValueError(f"unknown frames_format: {frames_format}")


# kernel route -> the `csrc/` library that holds its kernel
_ROUTE_LIBS = {"K1": "crops", "K2": "cascade", "K3": "cascade", "staged-K4": "assignment", "K5": "reid_block",
               "K8": "reid_epilogue", "K9+K10": "track_frame"}


def _kernel_modes(hp=None, platform: str = "cuda") -> Dict[str, str]:
    """Which routes a step of this configuration takes on `platform`: the
    crop gather (K1 on the card, the plain gather on the CPU), the
    association (K2 for all classes, K3 per class in scan mode or for one
    class, or the staged route with K4's fused stage; plain on the CPU),
    the ReID block (K5, where its switch is on), the ReID trunk's BN
    epilogue (K8), and the tracker's frame step around the association
    (K9 and K10)."""
    from vehicle_counting_tpu_torch.models.reid import _reid_block_on
    from vehicle_counting_tpu_torch.tracking.tracker import _use_cascade_kernel

    card = platform == "cuda"
    modes = {"crops": "K1" if card else "plain"}
    if hp is not None:
        if _use_cascade_kernel(hp.tracker):
            k = "K3" if hp.class_mode == "scan" or hp.num_classes == 1 else "K2"
            modes["cascade"] = k if card else "plain"
        else:
            modes["cascade"] = "staged-K4" if card else "staged-plain"
        if _reid_block_on():
            modes["reid_block"] = "K5" if card else "plain"
        modes["reid_epilogue"] = "K8" if card else "plain"
        modes["track_frame"] = "K9+K10" if card else "plain"
    return modes


@dataclasses.dataclass
class ExportedStep:
    """One exported function: the port's entry point (`module:name`), its
    static keyword arguments (JSON; `ycfg` and `hp` come from the
    manifest), whether the entry builds the step (called with the static
    arguments, and with a mesh of `nr_devices` where `mesh_axis` is set)
    or is the step (the static arguments bound to it), the [shape, dtype]
    specs of each positional input, the platform, and the kernel routes
    and libraries it launches."""

    entry: str
    static: Dict[str, Any]
    in_specs: List[List[list]]
    platform: str
    nr_devices: int = 1
    builder: bool = False
    mesh_axis: Optional[str] = None
    uses_hp: bool = True
    kernel_modes: Dict[str, str] = dataclasses.field(default_factory=dict)

    @property
    def kernels(self) -> List[str]:
        return sorted({_ROUTE_LIBS[m] for m in self.kernel_modes.values() if m in _ROUTE_LIBS})

    @property
    def platforms(self) -> List[str]:
        return [self.platform]


def _static_json(**kw) -> Dict[str, Any]:
    out = {}
    for k, v in kw.items():
        if isinstance(v, torch.dtype):
            v = _dtype_name(v)
        elif isinstance(v, tuple):
            v = list(v)
        out[k] = v
    return out


def _static_from_json(d: Dict[str, Any]) -> Dict[str, Any]:
    out = {}
    for k, v in d.items():
        if k == "dtype":
            v = getattr(torch, v)
        elif isinstance(v, list):
            v = tuple(v)
        out[k] = v
    return out


def _state_specs(hp, lead: Tuple[int, ...] = ()) -> List[list]:
    from vehicle_counting_tpu_torch.tracking.deepsort import init_states

    return [[list(lead) + s, d] for s, d in _specs(init_states(hp, "meta"))]


def export_pipeline_step(
    yolo_params,
    reid_params,
    reid_stats,
    *,
    ycfg,
    hp,
    batch: int,
    image_size: Tuple[int, int],
    src_hw: Tuple[int, int],
    conf_thres: float = 0.25,
    iou_thres: float = 0.45,
    max_det: int = 300,
    dtype=torch.bfloat16,
    frames_format: str = "letterboxed_yuv420",
    content_only: bool = True,
    platforms: Optional[Sequence[str]] = None,
) -> ExportedStep:
    """Export the detect + embed + track batch step
    (`pipeline/step.py::pipeline_batch_step`) for the weights' device."""
    platform = _platform(yolo_params, platforms)
    frames_shape = serving_frames_shape(frames_format, batch, src_hw, image_size, content_only)
    return ExportedStep(
        entry="vehicle_counting_tpu_torch.pipeline.step:pipeline_batch_step",
        static=_static_json(image_size=image_size, src_hw=src_hw, conf_thres=conf_thres, iou_thres=iou_thres,
                            max_det=max_det, dtype=dtype, frames_format=frames_format),
        in_specs=[_specs(yolo_params), _specs(reid_params), _specs(reid_stats), _state_specs(hp),
                  [[list(frames_shape), "uint8"]], [[[batch], "bool"]], [[[ycfg.num_classes], "int32"]]],
        platform=platform, kernel_modes=_kernel_modes(hp, platform),
    )


def export_detect_step(
    yolo_params,
    *,
    ycfg,
    batch: int,
    image_size: Tuple[int, int],
    src_hw: Tuple[int, int],
    conf_thres: float = 0.25,
    iou_thres: float = 0.45,
    max_det: int = 300,
    dtype=torch.bfloat16,
    content_only: bool = True,
    platforms: Optional[Sequence[str]] = None,
) -> ExportedStep:
    """Export the detect-only step (`pipeline/step.py::detect_only_step`,
    the I420 upload path). It launches none of the port's kernels."""
    from vehicle_counting_tpu_torch.ops.letterbox import content_upload_exact

    content = content_only and content_upload_exact(src_hw, image_size)
    frames_shape = serving_frames_shape("letterboxed_yuv420", batch, src_hw, image_size, content)
    return ExportedStep(
        entry="vehicle_counting_tpu_torch.pipeline.step:detect_only_step",
        static=_static_json(image_size=image_size, src_hw=src_hw, conf_thres=conf_thres, iou_thres=iou_thres,
                            max_det=max_det, dtype=dtype, content_only=content),
        in_specs=[_specs(yolo_params), [[list(frames_shape), "uint8"]]],
        platform=_platform(yolo_params, platforms), uses_hp=False,
    )


def export_multicam_step(
    yolo_params,
    reid_params,
    reid_stats,
    *,
    ycfg,
    hp,
    n_cameras: int,
    batch: int,
    image_size: Tuple[int, int],
    src_hw: Tuple[int, int],
    devices: Optional[Sequence[Any]] = None,
    conf_thres: float = 0.25,
    iou_thres: float = 0.45,
    max_det: int = 300,
    dtype=torch.bfloat16,
    frames_format: str = "letterboxed_yuv420",
    content_only: bool = True,
    platforms: Optional[Sequence[str]] = None,
) -> ExportedStep:
    """Export the camera-sharded step (`parallel/cameras.py::make_multicam_step`;
    class_lut comes fourth): states leaves [n_cameras, C, ...], frames
    [n_cameras, batch, ...] and frame_valid [n_cameras, batch] split over
    the mesh of `devices` (default: every card of the weights' platform,
    or one CPU entry), weights replicated; n_cameras must be a multiple of
    the device count. The artifact records the device count and loads on
    a mesh of that many devices of its platform (a host with fewer cards
    raises). Over several devices the loaded step takes and returns
    per-shard tuples, as `make_multicam_step` does; the input specs are the
    global shapes."""
    from vehicle_counting_tpu_torch.parallel.cameras import camera_params
    from vehicle_counting_tpu_torch.parallel.mesh import make_mesh

    platform = _platform(yolo_params, platforms)
    n = len(devices) if devices is not None else make_mesh(None, ("cam",), platform).size
    if n_cameras % n:
        raise ValueError(f"n_cameras={n_cameras} not divisible by {n} devices")
    frames_shape = (n_cameras,) + serving_frames_shape(frames_format, batch, src_hw, image_size, content_only)
    return ExportedStep(
        entry="vehicle_counting_tpu_torch.parallel.cameras:make_multicam_step",
        static=_static_json(image_size=image_size, src_hw=src_hw, conf_thres=conf_thres, iou_thres=iou_thres,
                            max_det=max_det, dtype=dtype, frames_format=frames_format),
        in_specs=[_specs(yolo_params), _specs(reid_params), _specs(reid_stats), [[[ycfg.num_classes], "int32"]],
                  _state_specs(hp, (n_cameras,)), [[list(frames_shape), "uint8"]], [[[n_cameras, batch], "bool"]]],
        platform=platform, nr_devices=n, builder=True, mesh_axis="cam",
        kernel_modes=_kernel_modes(camera_params(hp, n_cameras // n), platform),
    )


def export_framedp_step(
    yolo_params,
    reid_params,
    reid_stats,
    *,
    ycfg,
    hp,
    batch: int,
    image_size: Tuple[int, int],
    src_hw: Tuple[int, int],
    devices: Optional[Sequence[Any]] = None,
    conf_thres: float = 0.25,
    iou_thres: float = 0.45,
    max_det: int = 300,
    dtype=torch.bfloat16,
    frames_format: str = "letterboxed_yuv420",
    content_only: bool = True,
    platforms: Optional[Sequence[str]] = None,
) -> ExportedStep:
    """Export the frame-parallel single-camera step
    (`parallel/frames.py::make_framedp_step`; class_lut comes fourth).
    frames [batch, ...] and frame_valid [batch] split over the mesh's
    devices, `devices` (default: every card, or one CPU entry). The
    artifact records the device count; it loads on a mesh of that many
    devices of its platform, and batch must be a multiple of it."""
    from vehicle_counting_tpu_torch.parallel.mesh import make_mesh

    platform = _platform(yolo_params, platforms)
    n = len(devices) if devices is not None else make_mesh(None, ("frame",), platform).size
    if batch % n:
        raise ValueError(f"batch={batch} not divisible by {n} devices")
    frames_shape = serving_frames_shape(frames_format, batch, src_hw, image_size, content_only)
    return ExportedStep(
        entry="vehicle_counting_tpu_torch.parallel.frames:make_framedp_step",
        static=_static_json(image_size=image_size, src_hw=src_hw, conf_thres=conf_thres, iou_thres=iou_thres,
                            max_det=max_det, dtype=dtype, frames_format=frames_format),
        in_specs=[_specs(yolo_params), _specs(reid_params), _specs(reid_stats), [[[ycfg.num_classes], "int32"]],
                  _state_specs(hp), [[list(frames_shape), "uint8"]], [[[batch], "bool"]]],
        platform=platform, nr_devices=n, builder=True, mesh_axis="frame", kernel_modes=_kernel_modes(hp, platform),
    )


# ---------------------------------------------------------------------------
# artifact save / load
# ---------------------------------------------------------------------------


def _hp_to_json(hp) -> Dict[str, Any]:
    d = hp._asdict()
    d["tracker"] = dataclasses.asdict(hp.tracker)
    return d


def _hp_from_json(d: Dict[str, Any]):
    from vehicle_counting_tpu_torch.tracking.deepsort import DeepSortParams
    from vehicle_counting_tpu_torch.tracking.tracker import TrackerParams

    d = dict(d)
    d["tracker"] = TrackerParams(**d["tracker"])
    return DeepSortParams(**d)


def _ycfg_to_json(ycfg) -> Dict[str, Any]:
    return {
        "variant": ycfg.variant,
        "num_classes": ycfg.num_classes,
        "anchors": np.asarray(ycfg.anchors).tolist(),
        "strides": list(ycfg.strides),
    }


def _ycfg_from_json(d: Dict[str, Any]):
    from vehicle_counting_tpu_torch.models.yolo import YoloConfig

    return YoloConfig(
        variant=d["variant"],
        num_classes=d["num_classes"],
        anchors=tuple(tuple(tuple(a) for a in lvl) for lvl in d["anchors"]),
        strides=tuple(d["strides"]),
    )


def source_sha256() -> str:
    """sha256 over every `.py` of this package and its `csrc/*.cu` /
    `*.cuh`, each with its path: the source revision an artifact needs."""
    files = glob.glob(os.path.join(PACKAGE_DIR, "**", "*.py"), recursive=True)
    files += glob.glob(os.path.join(PACKAGE_DIR, "csrc", "*.cu")) + glob.glob(os.path.join(PACKAGE_DIR, "csrc", "*.cuh"))
    h = hashlib.sha256()
    for path in sorted(files):
        with open(path, "rb") as f:
            h.update(os.path.relpath(path, PACKAGE_DIR).encode() + b"\0" + f.read() + b"\0")
    return h.hexdigest()


def _file_sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def save_artifact(
    path: str,
    *,
    exported: Dict[str, ExportedStep],
    ycfg,
    hp=None,
    config: Optional[Dict[str, Any]] = None,
    class_lut=None,
    weights: Optional[Dict[str, Any]] = None,
) -> str:
    """Write the artifact directory. `exported` maps function name ->
    `ExportedStep`; `config` carries geometry / threshold metadata;
    `weights` (optional) bundles param trees for a self-contained
    artifact. A card export copies the kernel libraries its steps launch,
    building any that is not built yet."""
    from vehicle_counting_tpu_torch.utils.device import card_line

    platforms = {e.platform for e in exported.values()}
    if len(platforms) != 1:
        raise ValueError(f"one artifact, one platform: got {sorted(platforms)}")
    (platform,) = platforms
    os.makedirs(path, exist_ok=True)
    functions: Dict[str, Any] = {}
    for name, exp in exported.items():
        data = json.dumps(dataclasses.asdict(exp), indent=1, sort_keys=True).encode()
        fname = f"{name}.json"
        with open(os.path.join(path, fname), "wb") as f:
            f.write(data)
        functions[name] = {
            "file": fname,
            "sha256": hashlib.sha256(data).hexdigest(),
            "platforms": exp.platforms,
            "nr_devices": exp.nr_devices,
            "in_avals": exp.in_specs,
            "kernels": exp.kernels,
        }
    kernels: Dict[str, Any] = {}
    names = sorted({k for e in exported.values() for k in e.kernels})
    if names:
        from vehicle_counting_tpu_torch import _build

        _build.load_all(names)
        os.makedirs(os.path.join(path, KERNELS_DIR), exist_ok=True)
        for name in names:
            rel = os.path.join(KERNELS_DIR, os.path.basename(_build.library_path(name)))
            shutil.copyfile(_build.library_path(name), os.path.join(path, rel))
            kernels[name] = {"file": rel, "sha256": _file_sha256(os.path.join(path, rel)),
                             "key": _build.cache_key(name)}
    manifest: Dict[str, Any] = {
        "format_version": FORMAT_VERSION,
        "package_version": __version__,
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "card": card_line() if platform == "cuda" else None,
        "export_backend": platform,
        "source_sha256": source_sha256(),
        "kernel_modes": _kernel_modes(hp, platform),
        "functions": functions,
        "kernels": kernels,
        "ycfg": _ycfg_to_json(ycfg),
        "config": dict(config or {}),
    }
    if hp is not None:
        manifest["hp"] = _hp_to_json(hp)
    if class_lut is not None:
        manifest["class_lut"] = np.asarray(class_lut).astype(int).tolist()
    if weights is not None:
        save_weights_bundle(os.path.join(path, WEIGHTS_NAME), weights)
        manifest["weights_file"] = WEIGHTS_NAME
        manifest["weights_sha256"] = _file_sha256(os.path.join(path, WEIGHTS_NAME))
    with open(os.path.join(path, MANIFEST_NAME), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
    return path


class ServingArtifact:
    """A loaded artifact: its exported functions, bound to the port's entry
    points on demand, and its config."""

    def __init__(self, path: str, manifest: Dict[str, Any], exported: Dict[str, ExportedStep]):
        self.path = path
        self.manifest = manifest
        self._exported = exported
        self._bound: Dict[str, Any] = {}

    @classmethod
    def load(cls, path: str) -> "ServingArtifact":
        """Check and open an artifact: the format version, every file's
        sha256, the package's source against the exporter's, each kernel
        library's key; a card artifact needs a card. Then the artifact's
        own kernel libraries are registered (`_build.load_prebuilt`)."""
        from vehicle_counting_tpu_torch import _build

        with open(os.path.join(path, MANIFEST_NAME)) as f:
            manifest = json.load(f)
        if manifest["format_version"] > FORMAT_VERSION:
            raise ValueError(f"artifact format {manifest['format_version']} is newer than this package "
                             f"supports ({FORMAT_VERSION})")
        entries = list(manifest["functions"].values()) + list(manifest["kernels"].values())
        if "weights_file" in manifest:
            entries.append({"file": manifest["weights_file"], "sha256": manifest["weights_sha256"]})
        for entry in entries:
            if _file_sha256(os.path.join(path, entry["file"])) != entry["sha256"]:
                raise ValueError(f"{entry['file']}: sha256 mismatch (corrupt artifact)")
        here = source_sha256()
        if manifest["source_sha256"] != here:
            raise ValueError(f"artifact exported from port source {manifest['source_sha256']}, this package's "
                             f"source is {here}: an artifact runs only on the source revision that exported it")
        for name, k in manifest["kernels"].items():
            _build.check_prebuilt(name, os.path.join(path, k["file"]))
        if manifest["export_backend"] == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("this artifact was exported for the card, and no CUDA device is available")
        for name, k in manifest["kernels"].items():
            _build.load_prebuilt(name, os.path.join(path, k["file"]))
        exported = {}
        for name, entry in manifest["functions"].items():
            with open(os.path.join(path, entry["file"])) as f:
                exported[name] = ExportedStep(**json.load(f))
        return cls(path, manifest, exported)

    @property
    def function_names(self):
        return sorted(self._exported)

    @property
    def device(self) -> torch.device:
        return torch.device(self.manifest["export_backend"])

    @property
    def ycfg(self):
        return _ycfg_from_json(self.manifest["ycfg"])

    @property
    def hp(self):
        if "hp" not in self.manifest:
            raise ValueError("artifact has no tracker config (detect-only export)")
        return _hp_from_json(self.manifest["hp"])

    def init_states(self):
        """Fresh stacked per-class TrackerState matching the exported shapes,
        on the artifact's device."""
        from vehicle_counting_tpu_torch.tracking.deepsort import init_states

        return init_states(self.hp, self.device)

    def class_lut(self) -> torch.Tensor:
        if "class_lut" not in self.manifest:
            raise ValueError("artifact bundles no class_lut")
        return torch.tensor(self.manifest["class_lut"], dtype=torch.int32, device=self.device)

    def load_weights(self) -> Dict[str, Any]:
        """{'yolo': ..., 'reid': ..., 'reid_stats': ...} as CPU tensors, if bundled."""
        if "weights_file" not in self.manifest:
            raise ValueError("artifact bundles no weights")
        return load_weights_bundle(os.path.join(self.path, self.manifest["weights_file"]))

    def _check(self, name: str, args) -> None:
        exp = self._exported[name]
        if len(args) != len(exp.in_specs):
            raise TypeError(f"{name} takes {len(exp.in_specs)} inputs, got {len(args)}")
        for i, (arg, want) in enumerate(zip(args, exp.in_specs)):
            if exp.mesh_axis is not None and isinstance(arg, (list, tuple)) and not hasattr(arg, "_fields"):
                # the mesh's shards of one input: checked as the global value they make up
                shards = [_leaves(a) for a in arg]
                leaves = [leaf for s in shards for leaf in s]
                have = [[[sum(s[j].shape[0] for s in shards)] + list(t.shape[1:]), _dtype_name(t.dtype)]
                        for j, t in enumerate(shards[0])]
            else:
                leaves = _leaves(arg)
                have = [[list(t.shape), _dtype_name(t.dtype)] for t in leaves]
            if have != want:
                raise ValueError(f"{name} input {i}: leaves {have[:3]}... do not match the export's {want[:3]}...")
            bad = {str(t.device) for t in leaves if t.device.type != exp.platform}
            if bad:
                raise ValueError(f"{name} input {i} lies on {sorted(bad)}; the artifact runs on '{exp.platform}'")

    def jitted(self, name: str):
        """The exported function bound once (its entry point resolved, the
        manifest's static config applied, its mesh built), cached per
        name; its calls are checked against the export's input specs."""
        fn = self._bound.get(name)
        if fn is None:
            exp = self._exported[name]
            module, attr = exp.entry.split(":")
            entry = getattr(importlib.import_module(module), attr)
            kw = dict(_static_from_json(exp.static), ycfg=self.ycfg)
            if exp.uses_hp:
                kw["hp"] = self.hp
            if exp.mesh_axis is not None:
                from vehicle_counting_tpu_torch.parallel.mesh import make_mesh

                step = entry(make_mesh(exp.nr_devices, (exp.mesh_axis,), exp.platform), **kw)
            else:
                step = entry(**kw) if exp.builder else functools.partial(entry, **kw)

            def fn(*args, _name=name, _step=step):
                self._check(_name, args)
                # the inputs' device is current for the kernel wrappers' launches
                with on_device(_leaves(args)[0].device):
                    return _step(*args)

            self._bound[name] = fn
        return fn

    def call(self, name: str, *args):
        return self.jitted(name)(*args)

    def pipeline_step(self, yolo_params, reid_params, reid_stats, states, frames, frame_valid, class_lut):
        return self.call("pipeline_step", yolo_params, reid_params, reid_stats, states, frames, frame_valid,
                         class_lut)

    def detect_step(self, yolo_params, yuv):
        return self.call("detect_step", yolo_params, yuv)

    def bound_pipeline_step(self):
        """Self-contained closure over the bundled weights and class_lut on
        the artifact's device: step(states, frames, frame_valid) ->
        (new_states, det, track_outs). The returned state is a clone, so
        it stays what it was after the next call (on the card the step's
        own is the frame runner's, which the next call moves on)."""
        from vehicle_counting_tpu_torch.parallel.mesh import tree_to
        from vehicle_counting_tpu_torch.tracking.tracker import TrackerState

        w = tree_to(self.load_weights(), self.device)
        lut = self.class_lut()
        fn = self.jitted("pipeline_step")

        def step(states, frames, frame_valid):
            new_states, det, touts = fn(w["yolo"], w["reid"], w["reid_stats"], states, frames, frame_valid, lut)
            return TrackerState(*(x.clone() for x in new_states)), det, touts

        return step
