"""Box-order conversions and pairwise overlap matrices.

Port of `vehicle_counting_tpu/ops/boxes.py`. Conventions:
  xyxy = (x1, y1, x2, y2), tlwh = (x1, y1, w, h), cxcywh = (cx, cy, w, h),
  xyah = (cx, cy, w/h, h).
Functions take [..., 4] boxes; the matrices take one leading batch dim
at most ([..., N, 4] x [..., M, 4] -> [..., N, M]).
"""

from __future__ import annotations

import torch


def xyxy_to_tlwh(b: torch.Tensor) -> torch.Tensor:
    x1, y1, x2, y2 = b.unbind(-1)
    return torch.stack([x1, y1, x2 - x1, y2 - y1], dim=-1)


def tlwh_to_xyxy(b: torch.Tensor) -> torch.Tensor:
    x, y, w, h = b.unbind(-1)
    return torch.stack([x, y, x + w, y + h], dim=-1)


def xyxy_to_cxcywh(b: torch.Tensor) -> torch.Tensor:
    x1, y1, x2, y2 = b.unbind(-1)
    return torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1], dim=-1)


def cxcywh_to_xyxy(b: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = b.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], dim=-1)


def tlwh_to_xyah(b: torch.Tensor) -> torch.Tensor:
    """tlwh -> (center-x, center-y, aspect = w/h, h)."""
    x, y, w, h = b.unbind(-1)
    return torch.stack([x + w / 2, y + h / 2, w / torch.clamp(h, min=1e-6), h], dim=-1)


def xyah_to_tlwh(b: torch.Tensor) -> torch.Tensor:
    cx, cy, a, h = b.unbind(-1)
    w = a * h
    return torch.stack([cx - w / 2, cy - h / 2, w, h], dim=-1)


def clip_boxes(b: torch.Tensor, height, width) -> torch.Tensor:
    """Clip xyxy boxes into [0, width] x [0, height]."""
    x1, y1, x2, y2 = b.unbind(-1)
    return torch.stack([torch.clamp(x1, 0, width), torch.clamp(y1, 0, height),
                        torch.clamp(x2, 0, width), torch.clamp(y2, 0, height)], dim=-1)


def iou_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of xyxy boxes: [..., N, 4] x [..., M, 4] -> [..., N, M]."""
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = torch.clamp(a[..., 2] - a[..., 0], min=0.0) * torch.clamp(a[..., 3] - a[..., 1], min=0.0)
    area_b = torch.clamp(b[..., 2] - b[..., 0], min=0.0) * torch.clamp(b[..., 3] - b[..., 1], min=0.0)
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / torch.clamp(union, min=1e-9)


def tlwh_iou_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain IoU of tlwh boxes (SORT's IoU cost, no +1)."""
    return iou_matrix(tlwh_to_xyxy(a), tlwh_to_xyxy(b))


def sort_overlap_matrix(tlwh: torch.Tensor) -> torch.Tensor:
    """SORT-NMS overlap [..., N, N]: entry (i, j) = inter(i, j) / area(j),
    with the legacy +1 pixel convention."""
    b = tlwh.to(torch.float32)
    x1 = b[..., 0]
    y1 = b[..., 1]
    x2 = b[..., 0] + b[..., 2]
    y2 = b[..., 1] + b[..., 3]
    area = (x2 - x1 + 1.0) * (y2 - y1 + 1.0)
    xx1 = torch.maximum(x1[..., :, None], x1[..., None, :])
    yy1 = torch.maximum(y1[..., :, None], y1[..., None, :])
    xx2 = torch.minimum(x2[..., :, None], x2[..., None, :])
    yy2 = torch.minimum(y2[..., :, None], y2[..., None, :])
    w = torch.clamp(xx2 - xx1 + 1.0, min=0.0)
    h = torch.clamp(yy2 - yy1 + 1.0, min=0.0)
    return (w * h) / torch.clamp(area[..., None, :], min=1e-9)
