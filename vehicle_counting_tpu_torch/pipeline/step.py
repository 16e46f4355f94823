"""The per-batch device step: detect + track B frames.

Port of `vehicle_counting_tpu/pipeline/step.py` on the thin-upload
`letterboxed_yuv420` path with planar pixels:

    I420 (content rows) -> planar u8 RGB -> YOLOv5 -> decode/NMS tail ->
    box restore -> class map -> ReID crops (kernel K1) + CNN ->
    per-frame loop of the class-batched DeepSORT step (kernel K2)

One upload per batch and one small readback ([B, C, K] track rows).
PyTorch runs eagerly, so the JAX `jit`/`scan` become plain calls and a
Python loop over frames; the frame-independent tracker inputs are built
for all B frames at once before that loop.
"""

from __future__ import annotations

from typing import Tuple

import torch

from vehicle_counting_tpu_torch.models.detector import fused_detect_tail
from vehicle_counting_tpu_torch.models.yolo import YoloConfig, yolov5_forward_nchw
from vehicle_counting_tpu_torch.ops import true_div
from vehicle_counting_tpu_torch.ops.letterbox import (
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
from vehicle_counting_tpu_torch.tracking.tracker import TrackerOutputs


def detect_embed_core(yolo_params, reid_params, reid_stats, frames, frame_valid, class_lut, *,
                      ycfg: YoloConfig, hp: DeepSortParams, image_size: Tuple[int, int],
                      src_hw: Tuple[int, int], conf_thres: float = 0.25, iou_thres: float = 0.45,
                      max_det: int = 300, dtype=torch.bfloat16,
                      frames_format: str = "letterboxed_yuv420"):
    """The frame-independent front: pixels -> detections + ReID features.

    frames [B, rows*3/2, W] uint8 host-letterboxed I420 (content rows only,
    or the full letterbox); frame_valid [B] bool; class_lut [nc] int
    detector class -> tracked class (-1 drops). Returns (det, feats
    [B, max_det, F]) with det boxes in source pixels.
    """
    if frames_format != "letterboxed_yuv420":
        raise NotImplementedError(f"frames_format={frames_format!r} is not yet ported")
    if frames.shape[1] != image_size[0] * 3 // 2:
        # content-only upload: re-insert the constant gray padding
        frames = yuv420_content_to_full(frames, src_hw, image_size)
    crop_source = yuv420_to_rgb_u8_planar(frames)  # [B, 3, H, W] u8
    imgs = true_div(crop_source.to(torch.float32), 255.0).to(dtype)
    heads = [h.permute(0, 2, 3, 1) for h in yolov5_forward_nchw(yolo_params, imgs)]
    det = fused_detect_tail(heads, ycfg, conf_thres=conf_thres, iou_thres=iou_thres, max_det=max_det)
    det["boxes"] = restore_boxes(det["boxes"], src_hw, image_size)

    mapped = class_lut[torch.clamp(det["classes"], 0, class_lut.shape[0] - 1).long()]
    det_valid = det["valid"] & (mapped >= 0) & frame_valid[:, None]
    mapped = torch.where(det_valid, mapped, -1).to(torch.int32)

    gain, pad_x, pad_y, _, _ = letterbox_params(src_hw, image_size)
    feats = embed_detections_batch(
        crop_source, det["boxes"], det_valid, reid_params, reid_stats, hp,
        crop_gain=float(gain), crop_pad=(float(pad_x), float(pad_y)), dtype=dtype,
    )
    det["classes"] = mapped
    det["valid"] = det_valid
    return det, feats


def tracker_scan(states, det, feats, *, hp: DeepSortParams, src_hw: Tuple[int, int]):
    """The frame-recurrent back: DeepSORT over the batch's frames in order.
    Returns (states, TrackerOutputs with leaves [B, C, K, ...])."""
    inp = frame_inputs(feats, det["boxes"], det["scores"], det["classes"], det["valid"], hp)
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
