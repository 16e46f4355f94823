"""The per-batch device steps: detect + track B frames, or detect only.

Port of `vehicle_counting_tpu/pipeline/step.py`. `pipeline_batch_step`
takes one of three upload encodings (`frames_format`):

    letterboxed_yuv420  I420 (content rows or full) -> planar u8 RGB
    letterboxed_rgb     host-letterboxed [B, dh, dw, 3] u8
    raw_rgb             full [B, H, W, 3] u8, letterboxed on the device

then YOLOv5 -> decode/NMS tail -> box restore -> class map -> ReID crops
(kernel K1; an interleaved source on a planar copy) + CNN -> frame scan of
the DeepSORT step (kernel K2 for all classes, K3 per class in
`class_mode="scan"`, or K4 per stage on the staged route).
`detect_only_step` is the I420 front alone (the detect-only pass).

One upload per batch and one small readback ([B, C, K] track rows).
The frame-independent tracker inputs are built for all B frames at once;
the frame-recurrent step, which the JAX package runs as a `lax.scan`
inside one `jit`, is on the card one captured CUDA graph replayed per
frame (`tracking/graph.py::FrameRunner`), and on the CPU a plain Python
loop over `frame_update`.
"""

from __future__ import annotations

from typing import Tuple

import torch

from vehicle_counting_tpu_torch.models.detector import fused_detect_tail
from vehicle_counting_tpu_torch.models.yolo import YoloConfig, yolov5_forward_nchw
from vehicle_counting_tpu_torch.ops import true_div
from vehicle_counting_tpu_torch.ops.letterbox import (
    letterbox,
    letterbox_params,
    restore_boxes,
    yuv420_content_to_full,
    yuv420_to_rgb_u8_planar,
)
from vehicle_counting_tpu_torch.tracking.deepsort import (
    DeepSortParams,
    FrameInputs,
    embed_detections_batch,
    frame_inputs,
    frame_update,
)
from vehicle_counting_tpu_torch.tracking import tracker as tracker_mod
from vehicle_counting_tpu_torch.tracking.graph import FrameRunner
from vehicle_counting_tpu_torch.tracking.tracker import TrackerOutputs

# The frame scan's launch path, in the manner of
# `tracker.FORCE_CASCADE_KERNEL`. None: CUDA tensors replay the captured
# frame graph, CPU tensors run the eager loop; False: the eager loop on the
# card too (for comparing the two). A capture that fails raises: there is
# no fallback to the eager loop.
USE_FRAME_GRAPH = None

_RUNNERS = {}  # (hp, out_hw, device, association route) -> FrameRunner


def _runner_key(hp: DeepSortParams, src_hw: Tuple[int, int], device):
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return hp, tuple(src_hw), device, tracker_mod._use_cascade_kernel(hp.tracker)


def frame_runner(hp: DeepSortParams, src_hw: Tuple[int, int], device) -> FrameRunner:
    """The captured frame step for this configuration, built at first use.
    Each holds a static tracker state and its graph's memory pool until
    `free_frame_runner` or `free_frame_runners` drops it."""
    key = _runner_key(hp, src_hw, device)
    runner = _RUNNERS.get(key)
    if runner is None:
        runner = _RUNNERS[key] = FrameRunner(hp, src_hw, key[2])
    return runner


def free_frame_runner(hp: DeepSortParams, src_hw: Tuple[int, int], device) -> None:
    """Drop this configuration's captured frame step, on both association
    routes, with its static state and pool (a directory of cameras with
    different tracking configs would otherwise keep one per camera). A
    state it handed out stays readable."""
    key = _runner_key(hp, src_hw, device)
    for route in (False, True):
        _RUNNERS.pop(key[:3] + (route,), None)


def free_frame_runners() -> None:
    """Drop every captured frame step of the process."""
    _RUNNERS.clear()


def use_frame_graph(device) -> bool:
    return USE_FRAME_GRAPH is not False and torch.device(device).type == "cuda"


def _i420_pixels(yuv, src_hw: Tuple[int, int], image_size: Tuple[int, int]):
    """Host-letterboxed I420 (content rows only, or the full letterbox) ->
    planar u8 RGB [B, 3, H, W]."""
    if yuv.shape[1] != image_size[0] * 3 // 2:
        # content-only upload: re-insert the constant gray padding
        yuv = yuv420_content_to_full(yuv, src_hw, image_size)
    return yuv420_to_rgb_u8_planar(yuv)


def _net_input(rgb_u8, dtype):
    """u8 RGB -> the detector's input in [0, 1] (IEEE division by 255)."""
    return true_div(rgb_u8.to(torch.float32), 255.0).to(dtype)


def _detect(yolo_params, imgs, ycfg: YoloConfig, src_hw, image_size, conf_thres, iou_thres, max_det):
    """YOLOv5 on NCHW images -> the fused tail -> boxes in source pixels."""
    heads = [h.permute(0, 2, 3, 1) for h in yolov5_forward_nchw(yolo_params, imgs)]
    det = fused_detect_tail(heads, ycfg, conf_thres=conf_thres, iou_thres=iou_thres, max_det=max_det)
    det["boxes"] = restore_boxes(det["boxes"], src_hw, image_size)
    return det


def detect_only_step(yolo_params, yuv, *, ycfg: YoloConfig, image_size: Tuple[int, int],
                     src_hw: Tuple[int, int], conf_thres: float = 0.25, iou_thres: float = 0.45,
                     max_det: int = 300, dtype=torch.bfloat16):
    """The detect-only device step on the thin-upload I420 path:
    `pipeline_batch_step`'s letterboxed_yuv420 pixel path and detector
    without ReID or tracking (the reference's ImageDetect.run,
    modules/detect.py:30-60). yuv [B, rows*3/2, W] uint8, content rows or
    the full letterbox. Returns boxes [B, max_det, 4] xyxy in source pixels
    (zero where invalid), scores, classes, valid."""
    imgs = _net_input(_i420_pixels(yuv, src_hw, image_size), dtype)
    out = _detect(yolo_params, imgs, ycfg, src_hw, image_size, conf_thres, iou_thres, max_det)
    out["boxes"] = out["boxes"] * out["valid"][..., None]
    return out


def detect_embed_core(yolo_params, reid_params, reid_stats, frames, frame_valid, class_lut, *,
                      ycfg: YoloConfig, hp: DeepSortParams, image_size: Tuple[int, int],
                      src_hw: Tuple[int, int], conf_thres: float = 0.25, iou_thres: float = 0.45,
                      max_det: int = 300, dtype=torch.bfloat16,
                      frames_format: str = "letterboxed_yuv420"):
    """The frame-independent front: pixels -> detections + ReID features.

    frames as `frames_format` says (module docstring); frame_valid [B]
    bool; class_lut [nc] int detector class -> tracked class (-1 drops).
    Returns (det, feats [B, max_det, F]) with det boxes in source pixels.
    The crop source is the planar RGB of the I420 upload, or the uploaded
    frames themselves: the letterbox (through the gain/pad transform) or
    the raw frames at source resolution.
    """
    planar, crop_gain, crop_pad = True, 1.0, (0.0, 0.0)
    if frames_format == "raw_rgb":
        imgs = letterbox(frames, image_size).to(dtype).permute(0, 3, 1, 2).contiguous()
        crop_source, planar = frames, False
    else:
        if frames_format == "letterboxed_yuv420":
            crop_source = _i420_pixels(frames, src_hw, image_size)  # [B, 3, H, W] u8
            imgs = _net_input(crop_source, dtype)
        elif frames_format == "letterboxed_rgb":
            crop_source, planar = frames, False
            imgs = _net_input(frames, dtype).permute(0, 3, 1, 2).contiguous()
        else:
            raise ValueError(f"unknown frames_format: {frames_format!r}")
        gain, pad_x, pad_y, _, _ = letterbox_params(src_hw, image_size)
        crop_gain, crop_pad = float(gain), (float(pad_x), float(pad_y))
    det = _detect(yolo_params, imgs, ycfg, src_hw, image_size, conf_thres, iou_thres, max_det)

    mapped = class_lut[torch.clamp(det["classes"], 0, class_lut.shape[0] - 1).long()]
    det_valid = det["valid"] & (mapped >= 0) & frame_valid[:, None]
    mapped = torch.where(det_valid, mapped, -1).to(torch.int32)

    feats = embed_detections_batch(
        crop_source, det["boxes"], det_valid, reid_params, reid_stats, hp,
        crop_gain=crop_gain, crop_pad=crop_pad, dtype=dtype, planar=planar,
    )
    det["classes"] = mapped
    det["valid"] = det_valid
    return det, feats


def tracker_scan(states, det, feats, *, hp: DeepSortParams, src_hw: Tuple[int, int]):
    """The frame-recurrent back: DeepSORT over the batch's frames in order.
    Returns (states, TrackerOutputs with leaves [B, C, K, ...]). On the
    card (see `USE_FRAME_GRAPH`) the returned state is the frame runner's
    own static state: `states` is copied in unless it is the state the
    runner returned last, and is itself left untouched; clone the returned
    state to keep a snapshot, since the next scan moves those buffers on."""
    inp = frame_inputs(feats, det["boxes"], det["scores"], det["classes"], det["valid"], hp)
    if use_frame_graph(feats.device):
        return frame_runner(hp, src_hw, feats.device).run(states, inp)
    outs = []
    for i in range(feats.shape[0]):
        states, out = frame_update(states, FrameInputs(*(x[i] for x in inp)), hp, src_hw)
        outs.append(out)
    return states, TrackerOutputs(*(torch.stack(leaf) for leaf in zip(*outs)))


def pipeline_batch_step(yolo_params, reid_params, reid_stats, states, frames, frame_valid,
                        class_lut, *, ycfg: YoloConfig, hp: DeepSortParams,
                        image_size: Tuple[int, int], src_hw: Tuple[int, int],
                        conf_thres: float = 0.25, iou_thres: float = 0.45, max_det: int = 300,
                        dtype=torch.bfloat16, frames_format: str = "letterboxed_yuv420"):
    """Returns (new_states, det dict [B, max_det], TrackerOutputs [B, C, K]).
    The tracker gallery is updated in place."""
    det, feats = detect_embed_core(
        yolo_params, reid_params, reid_stats, frames, frame_valid, class_lut,
        ycfg=ycfg, hp=hp, image_size=image_size, src_hw=src_hw, conf_thres=conf_thres,
        iou_thres=iou_thres, max_det=max_det, dtype=dtype, frames_format=frames_format,
    )
    new_states, track_outs = tracker_scan(states, det, feats, hp=hp, src_hw=src_hw)
    return new_states, det, track_outs
