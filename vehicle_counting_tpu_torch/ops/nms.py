"""Fixed-shape greedy NMS (YOLO class-aware NMS and SORT's NMS).

Port of `vehicle_counting_tpu/ops/nms.py`. Greedy keep is computed as the
fixpoint of k[i] = valid[i] & ~any_{j<i}(k[j] & overlap[j, i] > thr) over
priority-sorted candidates, batched over any leading dims. The loop stops
when no image changes, which costs one host sync per iteration (a few per
batch), each a `sync.nms` span.
"""

from __future__ import annotations

from typing import Dict

import torch

from vehicle_counting_tpu_torch.ops.boxes import iou_matrix, sort_overlap_matrix
from vehicle_counting_tpu_torch.utils.profiling import span

# class-offset trick for class-aware NMS on one shared matrix
MAX_WH = 7680.0


def stable_topk(x: torch.Tensor, k: int):
    """Top-k along the last dim with lower-index-first ties (lax.top_k's rule)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def greedy_suppress(overlap: torch.Tensor, valid: torch.Tensor, threshold) -> torch.Tensor:
    """Exact greedy NMS keep-mask [..., K] by fixpoint iteration.

    overlap [..., K, K]: overlap[j, i] = how much keeping j suppresses i;
    rows/cols sorted by descending priority.
    """
    k = overlap.shape[-1]
    idx = torch.arange(k, device=overlap.device)
    pred = (idx[:, None] < idx[None, :]) & (overlap > threshold)  # j suppresses i
    keep = valid
    while True:
        new = valid & ~torch.any(pred & keep[..., :, None], dim=-2)
        with span("sync.nms"):
            same = torch.equal(new, keep)
        if same:
            return keep
        keep = new


def nms_selected(bx_k, top_sc, cl_k, valid, *, iou_threshold, max_det: int) -> Dict[str, torch.Tensor]:
    """Class-aware NMS over top-k-selected candidates, batched [..., k].

    Inputs are score-sorted (descending) candidates: boxes [..., k, 4] xyxy,
    scores [..., k] (invalid rows -1), classes [..., k] int32, valid [..., k].
    Returns boxes/scores/classes/valid with max_det rows, zero-padded.
    """
    k = bx_k.shape[-2]
    off = cl_k.to(torch.float32)[..., None] * MAX_WH
    iou = iou_matrix(bx_k + off, bx_k + off)
    keep = greedy_suppress(iou, valid, iou_threshold)

    kept_sc = torch.where(keep, top_sc, torch.full_like(top_sc, -1.0))
    out_k = min(max_det, k)
    out_sc, oidx = stable_topk(kept_sc, out_k)
    out_valid = out_sc > 0
    zero = ~out_valid
    boxes = torch.gather(bx_k, -2, oidx[..., None].expand(*oidx.shape, 4))
    out = {
        "boxes": torch.where(zero[..., None], torch.zeros_like(boxes), boxes),
        "scores": torch.where(zero, torch.zeros_like(out_sc), out_sc),
        "classes": torch.where(zero, torch.full_like(oidx, -1), torch.gather(cl_k.long(), -1, oidx)).to(torch.int32),
        "valid": out_valid,
    }
    pad = max_det - out_k
    if pad:
        lead = out_sc.shape[:-1]
        dev = out_sc.device
        out = {
            "boxes": torch.cat([out["boxes"], torch.zeros(*lead, pad, 4, device=dev)], -2),
            "scores": torch.cat([out["scores"], torch.zeros(*lead, pad, device=dev)], -1),
            "classes": torch.cat([out["classes"], torch.full((*lead, pad), -1, dtype=torch.int32, device=dev)], -1),
            "valid": torch.cat([out["valid"], torch.zeros(*lead, pad, dtype=torch.bool, device=dev)], -1),
        }
    return out


def batched_nms(boxes, scores, classes, *, iou_threshold=0.45, score_threshold=0.25,
                max_det: int = 300, pre_nms_topk: int = 512):
    """Class-aware NMS with fixed output shapes: boxes [B, N, 4] xyxy,
    scores [B, N], classes [B, N] -> dict of [B, max_det] arrays."""
    sc_m = torch.where(scores > score_threshold, scores, torch.full_like(scores, -1.0))
    k = min(pre_nms_topk, scores.shape[-1])
    top_sc, idx = stable_topk(sc_m, k)
    valid = top_sc > 0
    bx = torch.gather(boxes, 1, idx[..., None].expand(*idx.shape, 4))
    cl = torch.gather(classes.long(), 1, idx)
    return nms_selected(bx, top_sc, cl, valid, iou_threshold=iou_threshold, max_det=max_det)


def sort_nms_mask(tlwh: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
                  max_overlap) -> torch.Tensor:
    """SORT-flavor greedy suppression keep-mask [..., N] in INPUT order.

    Processing order: descending score, ties to the HIGHER original index
    (np.argsort ascending + take-last); j is suppressed when
    inter(i, j) / area(j) > max_overlap (+1 pixel convention).
    """
    n = tlwh.shape[-2]
    sc = torch.where(valid, scores, torch.full_like(scores, float("-inf")))
    idx = torch.arange(n, device=tlwh.device)
    before = (sc[..., None, :] > sc[..., :, None]) | (
        (sc[..., None, :] == sc[..., :, None]) & (idx[None, :] > idx[:, None])
    )
    rank = before.sum(-1)  # processing position of i
    order = torch.argsort(rank, dim=-1)  # order[rank[i]] = i (ranks are a permutation)
    tlwh_s = torch.gather(tlwh.to(torch.float32), -2, order[..., None].expand(*order.shape, 4))
    valid_s = torch.gather(valid, -1, order)
    keep_sorted = greedy_suppress(sort_overlap_matrix(tlwh_s), valid_s, max_overlap)
    return torch.gather(keep_sorted, -1, rank) & valid
