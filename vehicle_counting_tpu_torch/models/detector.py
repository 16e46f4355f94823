"""Detection step, detection tail and the host-facing `Detector`.

Port of `vehicle_counting_tpu/models/detector.py`: `detect_step` (raw
frames -> device letterbox -> YOLOv5 -> tail -> source-pixel boxes),
`Detector` (the reference's ImageDetect.run output contract),
`fused_detect_tail` in its default packed-rows mode, the class LUT.

The tail: decode + class-aware NMS with box decode deferred past the
top-k. The reference's
`exact_topk` (a grouped two-phase top-k, exact by its tie argument) is one
stable sort here: `ops/nms.py::stable_topk`.
Scores need only sigmoid(obj) * sigmoid(max class logit) for every
anchor; the box decode and the class argmax run on the pre_nms_topk
survivors only. The top-k keeps lax.top_k's lower-index-first tie rule
(a stable descending sort), so keeps, classes and order follow the
reference's `decode_predictions` + `batched_nms`.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from vehicle_counting_tpu_torch.models.yolo import (
    YoloConfig,
    cast_params,
    config_for_params,
    default_config,
    init_yolov5,
    yolov5_forward_nchw,
)
from vehicle_counting_tpu_torch.ops.letterbox import autoshape_hw, letterbox, restore_boxes
from vehicle_counting_tpu_torch.ops.nms import nms_selected, stable_topk

# COCO -> vehicle-class mapping the reference CLI defines (run.py:38-46):
# person/bicycle/motorcycle->motorcycle(0), car->car(1), bus->bus(2), truck->truck(3)
COCO_VEHICLE_MAPPING: Dict[int, int] = {0: 0, 1: 0, 2: 1, 3: 0, 5: 2, 7: 3}
VEHICLE_CLASS_NAMES: Tuple[str, ...] = ("motorbike", "car", "bus", "truck")


def class_lut(num_classes: int, mapping: Optional[Dict[int, int]]) -> np.ndarray:
    """[nc] int32 detector class -> tracked class (-1 drops); identity
    without a mapping."""
    if not mapping:
        return np.arange(num_classes, dtype=np.int32)
    lut = np.full((num_classes,), -1, np.int32)
    for src, dst in mapping.items():
        lut[int(src)] = int(dst)
    return lut


def fused_detect_tail(heads: Sequence[torch.Tensor], cfg: YoloConfig, *, conf_thres: float,
                      iou_thres: float, max_det: int, pre_nms_topk: int = 512) -> Dict[str, torch.Tensor]:
    """Decode + class-aware NMS of NHWC heads [B, Hs, Ws, na*no] (any dtype).

    Returns boxes [B, max_det, 4] xyxy in network-input pixels, scores,
    classes (int32, -1 pad) and valid, score-sorted and zero-padded.
    `fused_detect_tail.candidates` counts the anchors that enter the top-k
    (B x every anchor of every head), over all calls.
    """
    na, no, nc = cfg.na, cfg.no, cfg.num_classes
    b = heads[0].shape[0]
    dev = heads[0].device
    shapes = [(h.shape[1], h.shape[2]) for h in heads]
    offs = np.cumsum([0] + [h * w * na for (h, w) in shapes])
    k = min(pre_nms_topk, int(offs[-1]))
    fused_detect_tail.candidates += b * int(offs[-1])
    lane = torch.arange(nc, device=dev)

    scores, rows = [], []
    for head, (hh, ww) in zip(heads, shapes):
        flat = head.reshape(b, hh * ww, na, no)
        cls_logit = flat[..., 5:]
        cls_max = cls_logit.amax(-1)  # in the conv dtype, like the reference
        sc = torch.sigmoid(flat[..., 4].float()) * torch.sigmoid(cls_max.float())
        scores.append(sc.reshape(b, hh * ww * na))  # anchor-minor: cell * na + a
        # class index = first lane equal to the max (argmax's tie rule),
        # riding along as a 5th column of the candidate rows
        cls_idx = torch.where(cls_logit == cls_max[..., None], lane, nc).amin(-1)
        rows.append(torch.cat([flat[..., 0:4].float(), cls_idx[..., None].float()], -1)
                    .reshape(b, hh * ww * na, 5))
    sc = torch.cat(scores, 1)
    sc_m = torch.where(sc > conf_thres, sc, torch.full_like(sc, -1.0))
    top_sc, idx = stable_topk(sc_m, k)
    top_sc = torch.clamp(top_sc, min=-1.0)
    valid = top_sc > 0
    cand = torch.gather(torch.cat(rows, 1), 1, idx[..., None].expand(b, k, 5))
    cl_k = cand[..., 4].to(torch.int32)
    s_xywh = torch.sigmoid(cand[..., 0:4])

    # head, grid cell and anchor of each candidate from its global index
    h_id = torch.zeros_like(idx)
    for o in offs[1:-1]:
        h_id = h_id + (idx >= int(o)).to(idx.dtype)
    jj = idx - torch.as_tensor(offs[:-1], device=dev)[h_id]
    ww_t = torch.as_tensor([w for (_, w) in shapes], device=dev)[h_id]
    stride = torch.as_tensor([float(s) for s in cfg.strides], dtype=torch.float32, device=dev)[h_id]
    cell = torch.div(jj, na, rounding_mode="floor")
    gx = (cell % ww_t).to(torch.float32)
    gy = torch.div(cell, ww_t, rounding_mode="floor").to(torch.float32)
    anc_tbl = torch.as_tensor(np.asarray(cfg.anchors, np.float32).reshape(-1, 2), device=dev)
    anc = anc_tbl[h_id * na + (jj % na)]  # [B, k, 2]

    # same f32 expression order as decode_predictions
    x = (s_xywh[..., 0] * 2.0 - 0.5 + gx) * stride
    y = (s_xywh[..., 1] * 2.0 - 0.5 + gy) * stride
    wh = torch.square(s_xywh[..., 2:4] * 2.0) * anc
    x1 = x - wh[..., 0] / 2
    y1 = y - wh[..., 1] / 2
    bx_k = torch.stack([x1, y1, x1 + wh[..., 0], y1 + wh[..., 1]], dim=-1)
    return nms_selected(bx_k, top_sc, cl_k, valid, iou_threshold=iou_thres, max_det=max_det)


fused_detect_tail.candidates = 0


def detect_step(params, frames: torch.Tensor, *, cfg: YoloConfig, image_size: Tuple[int, int],
                src_hw: Tuple[int, int], conf_thres: float = 0.25, iou_thres: float = 0.45,
                max_det: int = 300, dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """Raw frames [B, H, W, 3] uint8 RGB -> fixed-shape detections: boxes
    [B, max_det, 4] xyxy in source pixels (zero where invalid), scores,
    classes, valid. `params` in `dtype` (`cast_params`)."""
    imgs = letterbox(frames, image_size).to(dtype).permute(0, 3, 1, 2)
    heads = [h.permute(0, 2, 3, 1) for h in yolov5_forward_nchw(params, imgs)]
    out = fused_detect_tail(heads, cfg, conf_thres=conf_thres, iou_thres=iou_thres, max_det=max_det)
    out["boxes"] = restore_boxes(out["boxes"], src_hw, image_size) * out["valid"][..., None]
    return out


class Detector:
    """Host-facing detector: owns the weights and config, detects on any
    source shape (`net_hw`'s AutoShape rule, or the configured square with
    `square_letterbox`). `run(frames)` keeps the reference ImageDetect.run
    output contract (modules/detect.py:30-60): per image a dict of tlwh
    'bboxes', 'classes', 'scores', after the optional class mapping.
    Runs on `device` (the card unless the caller asks for the CPU)."""

    def __init__(self, config, weights: Optional[str] = None, mapping_dict: Optional[Dict[int, int]] = None,
                 num_classes: Optional[int] = None, seed: int = 0, device="cuda"):
        from vehicle_counting_tpu_torch.utils.device import require_device

        self.device = require_device(device)
        variant = config.model_name or "yolov5s"
        image_size = config.image_size or [640, 640]
        self.image_size = (int(image_size[0]), int(image_size[1]))
        self.square_letterbox = bool(getattr(config, "square_letterbox", None))
        self.conf_thres = float(config.min_conf or 0.25)
        self.iou_thres = float(config.min_iou or 0.45)
        self.max_det = int(config.max_det) if (config.max_det or 0) > 0 else 300
        self.mapping_dict = mapping_dict
        self.dtype = torch.float32 if config.compute_dtype == "float32" else torch.bfloat16
        if weights:
            from vehicle_counting_tpu_torch.models.convert import load_yolov5_weights

            params = load_yolov5_weights(weights, self.device)
            self.cfg = config_for_params(variant, params)
            nc = self.cfg.num_classes
        else:
            nc = num_classes if num_classes is not None else 80
            self.cfg = default_config(variant, nc)
            params = init_yolov5(torch.Generator().manual_seed(seed), self.cfg, self.device)
        self.params = cast_params(params, self.dtype)
        self._map_lut = None
        if self.mapping_dict:
            self._map_lut = np.full(nc + 1, -1, dtype=np.int32)
            for src, dst in self.mapping_dict.items():
                self._map_lut[src] = dst

    def net_hw(self, src_hw: Tuple[int, int]) -> Tuple[int, int]:
        """Network input shape for a source shape (AutoShape rule, to the
        configuration's largest stride)."""
        if self.square_letterbox:
            return self.image_size
        return autoshape_hw(src_hw, self.image_size, stride=max(self.cfg.strides))

    def detect_batch(self, frames: np.ndarray) -> Dict[str, np.ndarray]:
        """frames [B, H, W, 3] uint8 RGB -> fixed-shape numpy detections."""
        _, h, w, _ = frames.shape
        with torch.no_grad():
            out = detect_step(self.params, torch.from_numpy(np.ascontiguousarray(frames)).to(self.device),
                              cfg=self.cfg, image_size=self.net_hw((h, w)), src_hw=(h, w),
                              conf_thres=self.conf_thres, iou_thres=self.iou_thres, max_det=self.max_det,
                              dtype=self.dtype)
        return {k: v.cpu().numpy() for k, v in out.items()}

    def run(self, frames: np.ndarray) -> List[Dict[str, np.ndarray]]:
        """Reference-style per-image outputs. The class mapping keeps only
        mapped classes and remaps their ids, as modules/detect.py:41-46
        intends, without the reference's off-by-one."""
        out = self.detect_batch(frames)
        results = []
        for i in range(frames.shape[0]):
            valid = out["valid"][i]
            boxes, classes, scores = out["boxes"][i][valid], out["classes"][i][valid], out["scores"][i][valid]
            if self._map_lut is not None:
                mapped = self._map_lut[np.clip(classes, 0, len(self._map_lut) - 1)]
                keep = mapped >= 0
                boxes, scores, classes = boxes[keep], scores[keep], mapped[keep]
            tlwh = boxes.copy()
            tlwh[:, 2] -= tlwh[:, 0]
            tlwh[:, 3] -= tlwh[:, 1]
            results.append({"bboxes": tlwh, "classes": classes, "scores": scores})
        return results
