"""Detection tail: decode + class-aware NMS with box decode deferred past the
top-k, plus the COCO -> vehicle class mapping.

Port of `vehicle_counting_tpu/models/detector.py` (`fused_detect_tail`
in its default packed-rows mode, the class LUT). The reference's
`exact_topk` (a grouped two-phase top-k, exact by its tie argument) is one
stable sort here: `ops/nms.py::stable_topk`.
Scores need only sigmoid(obj) * sigmoid(max class logit) for every
anchor; the box decode and the class argmax run on the pre_nms_topk
survivors only. The top-k keeps lax.top_k's lower-index-first tie rule
(a stable descending sort), so keeps, classes and order follow the
reference's `decode_predictions` + `batched_nms`.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from vehicle_counting_tpu_torch.models.yolo import YoloConfig
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
    """
    na, no, nc = cfg.na, cfg.no, cfg.num_classes
    b = heads[0].shape[0]
    dev = heads[0].device
    shapes = [(h.shape[1], h.shape[2]) for h in heads]
    offs = np.cumsum([0] + [h * w * na for (h, w) in shapes])
    k = min(pre_nms_topk, int(offs[-1]))
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
