"""Frame-parallel single-camera step: detect + embed split by frame over a mesh.

Port of `vehicle_counting_tpu/parallel/frames.py`. A camera's detections
and ReID features never read another frame, so the batch's B frames split
into n shards of B/n, shard i on `mesh.devices[i]`, each running
`pipeline/step.py::detect_embed_core` with that device's copy of the
weights. The per-frame results (boxes, scores, classes, valid, features:
small beside the pixels) go to `mesh.devices[0]` and are joined there in
frame order, the counterpart of the JAX step's tiled `all_gather`. The
tracker's frame recurrence then runs once, on `devices[0]`.

Two differences from the JAX step, by design:
  * JAX replicates the tracker scan on every device and gets the same
    result on each. One copy on `devices[0]` gives the same outputs with
    no collective (and the frame runners are keyed by device:
    `pipeline/step.py::frame_runner`).
  * JAX's `det` stays frame-sharded; here it is returned joined on
    `devices[0]`, where the tracker needed it anyway.

Numerics (the JAX package's contract): integer and boolean outputs
(classes, NMS keeps, track ids, masks) equal the single-device step run
at batch B/n with the states chained, since each shard is that step's
front on the same inputs at the same batch extent and the tracker sees
the frames in order. Float outputs may differ from the full-batch step
only by the convolutions' batch-extent rounding.

The shards run one after another on the host thread, and each shard's
embed reads a count back (`tracking/deepsort.py::_embed_compacted_chunks`,
`torch.nonzero`): the host waits there, so shards on different cards do
not yet overlap.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from vehicle_counting_tpu_torch.models.yolo import YoloConfig
from vehicle_counting_tpu_torch.parallel.mesh import DeviceMesh, weight_replicas
from vehicle_counting_tpu_torch.pipeline.step import detect_embed_core, tracker_scan
from vehicle_counting_tpu_torch.tracking.deepsort import DeepSortParams
from vehicle_counting_tpu_torch.utils.device import on_device

AXIS = "frame"


def _shards(x, n: int, what: str):
    """n equal shards along axis 0: the slices of a batch tensor, or the
    caller's own per-device shards (a list or tuple of n tensors)."""
    if isinstance(x, (list, tuple)):
        if len(x) != n or len({s.shape[0] for s in x}) != 1:
            raise ValueError(f"{what}: {len(x)} shards of rows {[s.shape[0] for s in x]}, want {n} equal shards")
        return list(x)
    if x.shape[0] % n:
        raise ValueError(f"frame-parallel batch size {x.shape[0]} must be a multiple of the mesh '{AXIS}' "
                         f"axis size {n}")
    return list(x.chunk(n))


# memoized, as in the JAX package: one configuration is one callable, and
# the callable keeps its per-device copies of the weights
@functools.lru_cache(maxsize=32)
def make_framedp_step(
    mesh: DeviceMesh,
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
    """The frame-sharded step with its static config bound.

    Returned callable: (yolo_params, reid_params, reid_stats, class_lut,
    states, frames [B, ...], frame_valid [B]) -> (new_states, det,
    track_outs), B a multiple of the mesh size. `frames` and `frame_valid`
    may also be lists of the n shards already on their devices (the
    pipeline uploads each shard straight to its device). `states` and
    every output live on `mesh.devices[0]`; on the card the returned
    state is the frame runner's own (`pipeline/step.py::tracker_scan`).
    The weights are copied to each device at the first call with a given
    set of weight objects and reused while the caller passes the same
    objects (a weight changed in place is not copied again).
    """
    devices = mesh.devices
    n = len(devices)
    front = functools.partial(
        detect_embed_core, ycfg=ycfg, hp=hp, image_size=image_size, src_hw=src_hw,
        conf_thres=conf_thres, iou_thres=iou_thres, max_det=max_det, dtype=dtype,
        frames_format=frames_format,
    )
    weights_on = weight_replicas()

    def step(yolo_params, reid_params, reid_stats, class_lut, states, frames, frame_valid):
        trees = (yolo_params, reid_params, reid_stats, class_lut)
        dets, feats = [], []
        for d, f, v in zip(devices, _shards(frames, n, "frames"), _shards(frame_valid, n, "frame_valid")):
            yp, rp, rs, lut = weights_on(d, trees)
            with on_device(d):
                det, ft = front(yp, rp, rs, f.to(d), v.to(d), lut)
            dets.append(det)
            feats.append(ft)
        d0 = devices[0]
        with on_device(d0):
            det = {k: torch.cat([x[k].to(d0) for x in dets]) for k in dets[0]}
            new_states, track_outs = tracker_scan(states, det, torch.cat([f.to(d0) for f in feats]),
                                                  hp=hp, src_hw=src_hw)
        return new_states, det, track_outs

    step.mesh = mesh
    return step
