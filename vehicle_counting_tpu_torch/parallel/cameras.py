"""Multi-camera step: every camera's detect + track batch, cameras over a mesh.

Port of `vehicle_counting_tpu/parallel/cameras.py`. The JAX package wraps
its batch step in `shard_map` over the mesh's 'cam' axis: the weights
replicated, states, frames and valid split with `P("cam")`, and the local
cameras scanned through the batch step on each device. Here the same
layout is a `parallel/mesh.py::DeviceMesh`:

  * shard i holds cameras [i * n_local, (i + 1) * n_local) on
    `mesh.devices[i]`, n_local = N_cam / mesh.size; a camera count that
    the mesh size does not divide raises, as `shard_map` does;
  * each shard runs the one-device step below on its cameras, with the
    device's copy of the weights (copied once per device, not per batch:
    `mesh.py::weight_replicas`);
  * one host thread dispatches every shard, in three passes over the
    shards: every camera's detector on every card; then every camera's
    embed, whose host read of its detection count (`torch.nonzero`) waits
    only for that card's detectors, launched in the first pass while the
    other cards run theirs; then every shard's frame scan, whose replays
    the cards run at once. The shard's device is current around its
    launches (the kernel wrappers launch on the current device), and the
    frame runners (`pipeline/step.py::frame_runner`, one per shard, `slot`
    i) are captured before the first pass. A host thread per shard runs
    slower: every PyTorch call hands the interpreter lock to another
    shard's thread, and at this step's thousands of small calls per batch
    four cards took 4.3-5.3x one card's time
    (`benchmarks/micro/camera_dispatch.py`);
  * `mesh=None` is the inputs' device alone, with no copy.

On the cameras of one shard:

  * the front runs per camera at the serial shapes: `detect_embed_core`'s
    halves on each camera's [B] frames, as `CountingPipeline.run_video` does,
    so each camera's detections and ReID features are the serial run's
    (one [N_cam * B] detector batch would change cuDNN's batch extent and
    with it the bf16 rounding near the thresholds);
  * the tracker inputs are slotted per camera with its C classes
    (`frame_inputs`) and joined on the class axis: [B, N_cam * C, K, ...];
  * one frame scan tracks all N_cam * C classes: each class has its own
    tracker state (its own `next_id`), so N cameras' trackers are N * C
    classes. On the card that is one replay of the frame graph per frame
    for every camera of the shard, with one launch of kernel K2 whose grid
    has N_cam * C blocks (K3 instead only where N_cam * C = 1 or in
    class_mode "scan").

Sharded values. A torch tensor lives on one device, so with a mesh of
more than one entry the states and the outputs are tuples of per-shard
trees: `states` is a tuple of mesh.size TrackerStates (leaves
[n_local, C, ...], shard i on devices[i]) and so is the returned state,
`track_outs` a tuple of TrackerOutputs (leaves [n_local, B, C, K, ...]).
`states` may also be one tree of [N_cam, C, ...] leaves (the initial
state, split and copied at that call), and `frames` / `frame_valid` one
[N_cam, ...] tensor or a tuple of per-shard tensors already on their
devices (the pipeline uploads each shard straight to its card).
`join_shards` gathers a sharded tree onto one device. With `mesh=None` or
a one-entry mesh every value is one tree, as on one card.

A state's leaves are [N_cam, C, ...] at this module's boundary and
[N_cam * C, ...] inside: a reshape of each other. A state this step
returned is the frame runner's own buffers seen as [N_cam, C, ...] views;
fed back, it is recognised as the runner's and not copied in. It stays
on its card.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Optional, Tuple

import torch

from vehicle_counting_tpu_torch.models.yolo import YoloConfig
from vehicle_counting_tpu_torch.parallel.mesh import DeviceMesh, weight_replicas
from vehicle_counting_tpu_torch.pipeline import step as step_mod
from vehicle_counting_tpu_torch.pipeline.step import detect_front, embed_front, scan_frame_inputs
from vehicle_counting_tpu_torch.tracking.deepsort import DeepSortParams, FrameInputs, frame_inputs
from vehicle_counting_tpu_torch.tracking.tracker import TrackerOutputs
from vehicle_counting_tpu_torch.utils.device import on_device

AXIS = "cam"


def camera_params(hp: DeepSortParams, n_cam: int) -> DeepSortParams:
    """The tracker's configuration for n_cam cameras of hp's C classes."""
    return hp._replace(num_classes=n_cam * hp.num_classes)


def regroup_states(states, lead: Tuple[int, ...]):
    """Every leaf's class axis (or camera and class axes) reshaped to
    `lead`: (N_cam * C,) <-> (N_cam, C). A view where the memory allows;
    a runner's handed-out state keeps its generation."""
    kept = 3 - len(lead)  # the first dim kept: after (N_cam * C,), or after (N_cam, C)
    out = type(states)(*(x.reshape(lead + x.shape[kept:]) for x in states))
    generation = getattr(states, "generation", None)
    if generation is not None:
        out.generation = generation
    return out


def _cameras_per_shard(mesh: DeviceMesh, n_cam: int) -> int:
    """Cameras per shard, N_cam / mesh.size; raises where the mesh size
    does not divide the camera count."""
    n = mesh.size
    if n_cam % n:
        raise ValueError(f"{n_cam} cameras do not split over the mesh '{AXIS}' axis of size {n}: the camera count "
                         f"must be a multiple of it (pad with invalid cameras)")
    return n_cam // n


def _split(x, mesh: DeviceMesh, what: str):
    """The mesh's shards of a camera-leading value: a list or tuple of
    per-shard values is taken as it is (one per device), anything else is cut into
    contiguous blocks along axis 0 and each block copied to its device."""
    n = mesh.size
    if isinstance(x, (list, tuple)) and not hasattr(x, "_fields"):
        if len(x) != n:
            raise ValueError(f"{what}: {len(x)} shards for a mesh of {n}")
        return list(x)
    if hasattr(x, "_fields"):  # one tree of [N_cam, ...] leaves
        nl = _cameras_per_shard(mesh, x[0].shape[0])
        return [type(x)(*(leaf[i * nl:(i + 1) * nl].to(d) for leaf in x)) for i, d in enumerate(mesh.devices)]
    nl = _cameras_per_shard(mesh, x.shape[0])
    return [x[i * nl:(i + 1) * nl].to(d) for i, d in enumerate(mesh.devices)]


def join_shards(value, device=None):
    """A sharded tree (a tuple of per-shard NamedTuples) joined along the
    camera axis on `device` (default: the first shard's), or one tree as
    it is (moved to `device` when given)."""
    if hasattr(value, "_fields"):
        return value if device is None else type(value)(*(x.to(device) for x in value))
    device = value[0][0].device if device is None else device
    return type(value[0])(*(torch.cat([s[i].to(device) for s in value]) for i in range(len(value[0]))))


# memoized, as in the JAX package: one configuration is one callable, and
# the callable keeps its per-device copies of the weights
@functools.lru_cache(maxsize=32)
def make_multicam_step(
    mesh: Optional[DeviceMesh],
    *,
    ycfg: YoloConfig,
    hp: DeepSortParams,
    image_size: Tuple[int, int],
    src_hw: Tuple[int, int],
    conf_thres: float = 0.25,
    iou_thres: float = 0.45,
    max_det: int = 300,
    dtype=torch.bfloat16,
    frames_format: str = "raw_rgb",
):
    """The camera-sharded step with its static config bound.

    Returned callable: (yolo_params, reid_params, reid_stats, class_lut,
    states, frames, frame_valid) -> (new_states, track_outs), with states
    leaves [N_cam, C, ...], frames [N_cam, B, ...] in `frames_format`,
    frame_valid [N_cam, B] bool and track_outs leaves [N_cam, B, C, K,
    ...]; over a mesh of several devices each of these is a tuple of
    per-shard values (module docstring). `mesh=None`: the inputs' device.
    """
    detect = functools.partial(
        detect_front, ycfg=ycfg, image_size=image_size, src_hw=src_hw, conf_thres=conf_thres,
        iou_thres=iou_thres, max_det=max_det, dtype=dtype, frames_format=frames_format,
    )
    c = hp.num_classes

    def run(shards):
        """shards: [(slot, device (None: as the inputs lie), (yolo_params,
        reid_params, reid_stats, class_lut), states, frames, frame_valid)],
        each shard's values on its device -> [(new_states, track_outs)]."""
        def current(device):
            return contextlib.nullcontext() if device is None else on_device(device)

        fronts = []
        for _, d, (yp, _, _, lut), _, frames, valid in shards:
            with current(d):
                fronts.append([detect(yp, frames[i], valid[i], lut) for i in range(frames.shape[0])])
        inputs = []
        for (_, d, (_, rp, rs, _), *_), dets in zip(shards, fronts):
            with current(d):
                # slotted with each camera's C classes, tracked with N_cam * C
                per_cam = [frame_inputs(embed_front(rp, rs, det, crop, hp=hp, dtype=dtype), det["boxes"],
                                        det["scores"], det["classes"], det["valid"], hp) for det, crop in dets]
                inputs.append(FrameInputs(*(torch.cat(leaf, dim=1) for leaf in zip(*per_cam))))
        del fronts
        out = []
        for (slot, d, _, states, frames, _), inp in zip(shards, inputs):
            n_cam, b = frames.shape[0], inp.valid.shape[0]
            with current(d):
                new_states, outs = scan_frame_inputs(regroup_states(states, (n_cam * c,)), inp,
                                                     hp=camera_params(hp, n_cam), src_hw=src_hw, slot=slot)
            outs = TrackerOutputs(*(o.reshape((b, n_cam, c) + o.shape[2:]).transpose(0, 1) for o in outs))
            out.append((regroup_states(new_states, (n_cam, c)), outs))
        return out

    if mesh is None:
        def step(yolo_params, reid_params, reid_stats, class_lut, states, frames, frame_valid):
            return run([(0, None, (yolo_params, reid_params, reid_stats, class_lut), states, frames, frame_valid)])[0]

        step.mesh = None
        return step

    devices = mesh.devices
    weights_on = weight_replicas()

    def step(yolo_params, reid_params, reid_stats, class_lut, states, frames, frame_valid):
        frames_s = _split(frames, mesh, "frames")
        valid_s = _split(frame_valid, mesh, "frame_valid")
        states_s = _split(states, mesh, "states")
        n_local = frames_s[0].shape[0]
        if any(f.shape[0] != n_local for f in frames_s):
            raise ValueError(f"frames: shards of {[f.shape[0] for f in frames_s]} cameras, want equal shards")
        trees = (yolo_params, reid_params, reid_stats, class_lut)
        for i, d in enumerate(devices):
            if step_mod.use_frame_graph(d):
                with on_device(d):  # captured before any shard launches
                    step_mod.frame_runner(camera_params(hp, n_local), src_hw, d, i)
        out = run([(i, d, weights_on(d, trees), states_s[i], frames_s[i], valid_s[i]) for i, d in enumerate(devices)])
        if len(devices) == 1:
            return out[0]
        return tuple(s for s, _ in out), tuple(o for _, o in out)

    step.mesh = mesh
    return step


def multicam_batch_step(
    mesh: Optional[DeviceMesh],
    yolo_params,
    reid_params,
    reid_stats,
    states,          # per-camera TrackerState stacked: leaves [N_cam, C, ...]
    frames,          # [N_cam, B, ...] in frames_format
    frame_valid,     # [N_cam, B] bool
    class_lut,       # [nc]
    *,
    ycfg: YoloConfig,
    hp: DeepSortParams,
    image_size: Tuple[int, int],
    src_hw: Tuple[int, int],
    conf_thres: float = 0.25,
    iou_thres: float = 0.45,
    max_det: int = 300,
    dtype=torch.bfloat16,
    frames_format: str = "raw_rgb",
):
    """One batch step for every camera at once, cameras sharded over the
    mesh's 'cam' axis (`mesh=None`: the inputs' device). Returns (new
    states, leaves [N_cam, C, ...]; TrackerOutputs, leaves [N_cam, B, C,
    K, ...]), per-shard tuples of them over a mesh of several devices. A
    camera whose frames are all invalid (an exhausted video) has no
    detection, so none of its classes advances. The tracker gallery is
    updated in place; on the card the returned state is the frame
    runner's (see `pipeline/step.py::tracker_scan`)."""
    step = make_multicam_step(
        mesh, ycfg=ycfg, hp=hp, image_size=image_size, src_hw=src_hw, conf_thres=conf_thres,
        iou_thres=iou_thres, max_det=max_det, dtype=dtype, frames_format=frames_format,
    )
    return step(yolo_params, reid_params, reid_stats, class_lut, states, frames, frame_valid)
