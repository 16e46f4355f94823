"""Weighted Boxes Fusion (WBF) — working implementation of the reference's
box-fusion contract.

The reference's postprocess chain advertises `box_fusion` with modes 'wbf'
and 'nms' (utilities/postprocess.py:128-240) but never imports the
ensemble-boxes package it calls, so any mode other than None raises
NameError there. This is the functional version: fuse overlapping same-class
boxes from one or more models into confidence-weighted averages
(Solovyev et al., the standard WBF algorithm).

Host-side numpy: fusion runs once per image on <= a few hundred boxes; it is
an ensembling tool, not a hot path. The port's own copy of
`vehicle_counting_tpu/ops/fusion.py` (which holds no JAX code), kept so the
port imports nothing of the JAX package.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def _iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    lt = np.maximum(a[:2], b[:, :2])
    rb = np.minimum(a[2:], b[:, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[:, 0] * wh[:, 1]
    area_a = (a[2] - a[0]) * (a[3] - a[1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / np.maximum(area_a + area_b - inter, 1e-9)


def weighted_boxes_fusion(
    boxes_list: Sequence[np.ndarray],
    scores_list: Sequence[np.ndarray],
    labels_list: Sequence[np.ndarray],
    iou_thr: float = 0.55,
    skip_box_thr: float = 0.0,
    weights: Sequence[float] | None = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Fuse per-model detections. boxes xyxy; returns (boxes, scores, labels).

    Score of a fused cluster is the weighted mean, rescaled by
    min(n_contributors, n_models) / n_models (standard WBF confidence
    adjustment).
    """
    n_models = len(boxes_list)
    if weights is None:
        weights = [1.0] * n_models
    rows = []
    for m, (bs, ss, ls) in enumerate(zip(boxes_list, scores_list, labels_list)):
        bs = np.asarray(bs, np.float64).reshape(-1, 4)
        ss = np.asarray(ss, np.float64) * weights[m]
        ls = np.asarray(ls)
        for b, s, l in zip(bs, ss, ls):
            if s > skip_box_thr:
                rows.append((b, s, int(l)))
    if not rows:
        return np.zeros((0, 4)), np.zeros(0), np.zeros(0, np.int64)

    out_boxes, out_scores, out_labels = [], [], []
    for label in sorted({r[2] for r in rows}):
        sub = sorted((r for r in rows if r[2] == label), key=lambda r: -r[1])
        clusters: List[List[Tuple[np.ndarray, float]]] = []
        fused: List[np.ndarray] = []
        for b, s, _ in sub:
            if fused:
                ious = _iou(b, np.stack(fused))
                j = int(np.argmax(ious))
                if ious[j] >= iou_thr:
                    clusters[j].append((b, s))
                    w = np.array([c[1] for c in clusters[j]])
                    bb = np.stack([c[0] for c in clusters[j]])
                    fused[j] = (bb * w[:, None]).sum(0) / w.sum()
                    continue
            clusters.append([(b, s)])
            fused.append(b.copy())
        for cl, fb in zip(clusters, fused):
            w = np.array([c[1] for c in cl])
            score = w.mean() * min(len(cl), n_models) / n_models
            out_boxes.append(fb)
            out_scores.append(score)
            out_labels.append(label)
    order = np.argsort(-np.asarray(out_scores), kind="stable")
    return (
        np.stack(out_boxes)[order],
        np.asarray(out_scores)[order],
        np.asarray(out_labels, np.int64)[order],
    )


def filter_area(boxes: np.ndarray, min_wh: float = 2.0, max_wh: float = 4096.0) -> np.ndarray:
    """Keep-mask for boxes within [min_wh, max_wh] side lengths
    (utilities/postprocess.py:44-70 contract)."""
    b = np.asarray(boxes, np.float64).reshape(-1, 4)
    w = b[:, 2] - b[:, 0]
    h = b[:, 3] - b[:, 1]
    return (w >= min_wh) & (h >= min_wh) & (w <= max_wh) & (h <= max_wh)
