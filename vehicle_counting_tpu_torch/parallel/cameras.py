"""Multi-camera step: every camera's detect + track batch on one card.

Port of `vehicle_counting_tpu/parallel/cameras.py`. The JAX package shards
cameras over a mesh axis and scans the local cameras through its batch
step; here the cameras share one card and the step takes no mesh (across
processes each one runs its own cameras: `parallel/mesh.py`):

  * the front runs per camera at the serial shapes: `detect_embed_core` on
    each camera's [B] frames, exactly as `CountingPipeline.run_video` does,
    so each camera's detections and ReID features are the serial run's
    (one [N_cam * B] detector batch would change cuDNN's batch extent and
    with it the bf16 rounding near the thresholds);
  * the tracker inputs are slotted per camera with its C classes
    (`frame_inputs`) and joined on the class axis: [B, N_cam * C, K, ...];
  * one frame scan tracks all N_cam * C classes: each class has its own
    tracker state (its own `next_id`), so N cameras' trackers are N * C
    classes. On the card that is one replay of the frame graph per frame
    for every camera, with one launch of kernel K2 whose grid has N_cam * C
    blocks (K3 instead only where N_cam * C = 1 or in class_mode "scan").

The state's leaves are [N_cam, C, ...] at this module's boundary and
[N_cam * C, ...] inside: a reshape of each other. A state this step
returned is the frame runner's own buffers seen as [N_cam, C, ...] views;
fed back, it is recognised as the runner's and not copied in.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from vehicle_counting_tpu_torch.models.yolo import YoloConfig
from vehicle_counting_tpu_torch.pipeline.step import detect_embed_core, scan_frame_inputs
from vehicle_counting_tpu_torch.tracking.deepsort import DeepSortParams, FrameInputs, frame_inputs
from vehicle_counting_tpu_torch.tracking.tracker import TrackerOutputs


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


@functools.lru_cache(maxsize=32)
def make_multicam_step(
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
    """The multi-camera step with its static config bound (memoized, as in
    the JAX package, so one configuration is one callable).

    Returned callable: (yolo_params, reid_params, reid_stats, class_lut,
    states, frames, frame_valid) -> (new_states, track_outs), with states
    leaves [N_cam, C, ...], frames [N_cam, B, ...] in `frames_format`,
    frame_valid [N_cam, B] bool and track_outs leaves [N_cam, B, C, K, ...].
    Unlike the JAX builder it takes no mesh: one card has none.
    """
    front = functools.partial(
        detect_embed_core, ycfg=ycfg, hp=hp, image_size=image_size, src_hw=src_hw,
        conf_thres=conf_thres, iou_thres=iou_thres, max_det=max_det, dtype=dtype,
        frames_format=frames_format,
    )

    def step(yolo_params, reid_params, reid_stats, class_lut, states, frames, frame_valid):
        n_cam, c = frames.shape[0], hp.num_classes
        per_cam = []
        for i in range(n_cam):
            det, feats = front(yolo_params, reid_params, reid_stats, frames[i], frame_valid[i], class_lut)
            # slotted with the camera's C classes, tracked with N_cam * C
            per_cam.append(frame_inputs(feats, det["boxes"], det["scores"], det["classes"], det["valid"], hp))
        inp = FrameInputs(*(torch.cat(leaf, dim=1) for leaf in zip(*per_cam)))
        new_states, outs = scan_frame_inputs(
            regroup_states(states, (n_cam * c,)), inp, hp=camera_params(hp, n_cam), src_hw=src_hw,
        )
        b = inp.valid.shape[0]
        outs = TrackerOutputs(*(o.reshape((b, n_cam, c) + o.shape[2:]).transpose(0, 1) for o in outs))
        return regroup_states(new_states, (n_cam, c)), outs

    return step


def multicam_batch_step(
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
    """One batch step for every camera at once. Returns (new states, leaves
    [N_cam, C, ...]; TrackerOutputs, leaves [N_cam, B, C, K, ...]). A camera
    whose frames are all invalid (an exhausted video) has no detection, so
    none of its classes advances. The tracker gallery is updated in place;
    on the card the returned state is the frame runner's (see
    `pipeline/step.py::tracker_scan`)."""
    step = make_multicam_step(
        ycfg=ycfg, hp=hp, image_size=image_size, src_hw=src_hw, conf_thres=conf_thres,
        iou_thres=iou_thres, max_det=max_det, dtype=dtype, frames_format=frames_format,
    )
    return step(yolo_params, reid_params, reid_stats, class_lut, states, frames, frame_valid)
