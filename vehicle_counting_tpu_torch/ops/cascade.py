"""Per-frame DeepSORT association for all classes (kernel K2, entry K3).

Port of the TPU kernels `ops/pallas/cascade.py::cascade_match_classparallel`
(K2) and `::cascade_match_batched` (K3) into ONE CUDA kernel
(`csrc/cascade.cu`, one thread block per class), and of the staged
association `tracking/tracker.py::_associate_xla` + `_match_stage`, which
is the plain version (`associate_plain`).

What is computed, per class: the matching cascade over occupied age
levels (linear_assignment.py:126-141) -- per level a scipy-exact Hungarian
solve of the gated appearance cost, matches above `max_dist` rejected and
their detections demoted to the end of the unmatched list -- then the IoU
stage on tentative and just-missed tracks (tracker.py:117-127).

Outputs: det_free [C, K] bool, det_key [C, K] i32 (unmatched-list order
keys that decide new track ids) and out_row [C, K] i32 (detection slot ->
matched track slot, -1 none). The kernel is bitwise-equal to the plain
version: its arithmetic is f32 subtraction and comparison only.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from vehicle_counting_tpu_torch import _build
from vehicle_counting_tpu_torch.tracking.assignment import matching_cost_matrix, solve_assignment_sub

IMAX = 2147483647
# demoted det keys reach (max_age + 2) * K; the kernel packs key and lane
# into one 31-bit word, like the TPU kernel's exact-f32 range gate
KEY_LIMIT = 1 << 22
MAX_K = 256


def _clamp_value(threshold: float) -> float:
    """f32 value of threshold + 1e-5 (min_cost_matching's clamp)."""
    return float(np.float32(threshold + 1e-5))


def _match_stage(cost, rows, det_free, track_col, threshold, row_order, det_key, stage_base):
    """One min_cost_matching pass over masked rows/cols (one class).

    Rows and columns are compacted into the reference's orders (rows by
    `row_order`, columns by the unmatched-list key) so scipy's index-order
    tie-breaking applies. Rejected matches demote their detection to key
    stage_base * K + (rejection rank in row order). Returns
    (det_free, track_col, det_key).
    """
    k = cost.shape[0]
    nr = int(rows.sum())
    nc = int(det_free.sum())
    if nr == 0 or nc == 0:
        return det_free, track_col, det_key
    imax = torch.full_like(row_order, IMAX)
    row_perm = torch.argsort(torch.where(rows, row_order, imax), stable=True)
    col_perm = torch.argsort(torch.where(det_free, det_key, imax), stable=True)
    c = matching_cost_matrix(cost, rows, det_free, _clamp_value(threshold))
    c2 = c[row_perm][:, col_perm]
    r2c = solve_assignment_sub(c2, nr, nc)  # permuted row -> permuted col

    a = torch.arange(k)
    paired = (a < nr) & (r2c >= 0) & (r2c < nc)
    r2c_c = torch.clamp(r2c, 0, k - 1)
    cost_at = c2[a, r2c_c]
    accept = paired & (cost_at <= np.float32(threshold))
    reject = paired & ~accept
    slot_col = col_perm[r2c_c]

    track_col = track_col.clone()
    track_col[row_perm[accept]] = slot_col[accept].to(track_col.dtype)
    det_free = det_free.clone()
    det_free[slot_col[accept]] = False
    rank = torch.cumsum(reject.to(torch.int64), 0) - 1
    det_key = det_key.clone()
    det_key[slot_col[reject]] = (stage_base * k + rank[reject]).to(det_key.dtype)
    return det_free, track_col, det_key


def associate_plain(gated, iou_cost, lvl_of, tentative, track_id, iou_order,
                    det_valid, det_order, max_dist, max_iou, max_age):
    """Staged association of one class -> (det_free, track_col, det_key).

    gated/iou_cost [K, K] (track x detection), lvl_of [K] i32 cascade level
    (IMAX when not in the cascade), tentative/det_valid [K] bool,
    track_id/iou_order [K] i32 row order keys, det_order [K] i32 initial
    unmatched-list keys. Levels are walked in ascending order, skipping
    empty ones, while free detections remain.
    """
    k = gated.shape[0]
    det_free = det_valid.clone()
    track_col = torch.full((k,), -1, dtype=torch.int32)
    det_key = det_order.clone()
    levels = sorted(set(lvl_of[lvl_of != IMAX].tolist()))
    for level in levels:
        if not bool(det_free.any()):
            break
        det_free, track_col, det_key = _match_stage(
            gated, lvl_of == level, det_free, track_col, max_dist,
            track_id, det_key, 1 + level,
        )
    iou_rows = tentative | ((lvl_of == 0) & (track_col < 0))
    det_free, track_col, det_key = _match_stage(
        iou_cost, iou_rows, det_free, track_col, max_iou,
        iou_order, det_key, 1 + max_age,
    )
    return det_free, track_col, det_key


def _cascade_plain(gated_c, iou_c, lvl_of, tentative, row_key, iou_key,
                   det_valid, det_order, max_dist, max_iou, max_age):
    """Plain version of the kernel: `associate_plain` class by class."""
    c, k, _ = gated_c.shape
    det_free = torch.zeros((c, k), dtype=torch.bool)
    det_key = torch.zeros((c, k), dtype=torch.int32)
    out_row = torch.full((c, k), -1, dtype=torch.int32)
    for ci in range(c):
        free, track_col, key = associate_plain(
            gated_c[ci].float(), iou_c[ci].float(), lvl_of[ci].to(torch.int32),
            tentative[ci].bool(), row_key[ci].to(torch.int32), iou_key[ci].to(torch.int32),
            det_valid[ci].bool(), det_order[ci].to(torch.int32), max_dist, max_iou, max_age,
        )
        det_free[ci] = free
        det_key[ci] = key
        matched = torch.nonzero(track_col >= 0).flatten()
        out_row[ci, track_col[matched].long()] = matched.to(torch.int32)
    return det_free, det_key, out_row


_ARGTYPES = (
    [ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.c_int]
    + [ctypes.c_float] * 4 + [ctypes.c_int] + [ctypes.c_void_p] * 4
)


def _launch(gated_c, iou_c, lvl_of, tentative, row_key, iou_key, det_valid,
            det_order, max_dist, max_iou, max_age):
    """Check the operands and launch the CUDA kernel: one block per class."""
    dev = gated_c.device
    c, k, k2 = gated_c.shape
    if k != k2 or iou_c.shape != (c, k, k):
        raise ValueError(f"cost matrices must be [C, K, K], got {tuple(gated_c.shape)} and {tuple(iou_c.shape)}")
    if k > MAX_K:
        raise ValueError(f"association kernel takes K <= {MAX_K}, got {k}")
    if (max_age + 2) * k >= KEY_LIMIT:
        raise ValueError(f"(max_age + 2) * K = {(max_age + 2) * k} exceeds the kernel's key range {KEY_LIMIT}")
    if gated_c.dtype != torch.float32 or iou_c.dtype != torch.float32:
        raise ValueError("cost matrices must be float32")
    ints = []
    for name, t in (("lvl_of", lvl_of), ("tentative", tentative), ("row_key", row_key),
                    ("iou_key", iou_key), ("det_valid", det_valid), ("det_order", det_order)):
        if t.shape != (c, k) or t.device != dev:
            raise ValueError(f"{name} must be [C, K] on {dev}, got {tuple(t.shape)} on {t.device}")
        ints.append(t.to(torch.int32).contiguous())
    gated_c = gated_c.contiguous()
    iou_c = iou_c.contiguous()
    out = torch.empty((3, c, k), dtype=torch.int32, device=dev)
    fn = _build.entry("cascade", "vct_cascade_match", _ARGTYPES)
    rc = fn(
        gated_c.data_ptr(), iou_c.data_ptr(), *(t.data_ptr() for t in ints),
        c, k,
        float(np.float32(max_dist)), float(np.float32(max_iou)),
        _clamp_value(max_dist), _clamp_value(max_iou), int(max_age),
        out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
        _build.current_stream(dev),
    )
    _build.check(rc, "cascade association kernel")
    return out[1] != 0, out[2], out[0]  # det_free, det_key, out_row


def _dispatch(wrapper, args):
    if args[0].device.type == "cpu":
        return _cascade_plain(*args)
    if args[0].device.type != "cuda":
        raise ValueError(f"unsupported device {args[0].device}")
    out = _launch(*args)
    wrapper.launches += 1
    return out


def cascade_match_classparallel(gated_c, iou_c, lvl_of, tentative, row_key, iou_key,
                                det_valid, det_order, max_dist, max_iou, *, max_age: int):
    """K2: full cascade + IoU association for [C] classes in one launch.

    Args (all leading [C]): gated_c [C, K, K] cascade cost (appearance with
    Mahalanobis gating, BIG at invalid detections), iou_c [C, K, K] IoU cost
    (tsu > 1 rows at INFTY), lvl_of [C, K] cascade level per track slot
    (IMAX when not participating), tentative [C, K], row_key / iou_key
    [C, K] cascade / IoU row order keys (ranked stably in the kernel),
    det_valid [C, K], det_order [C, K] initial unmatched-list keys.
    Returns (det_free [C, K] bool, det_key [C, K] i32, out_row [C, K] i32).
    """
    return _dispatch(
        cascade_match_classparallel,
        (gated_c, iou_c, lvl_of, tentative, row_key, iou_key, det_valid, det_order,
         max_dist, max_iou, max_age),
    )


def cascade_match_batched(gated_c, iou_c, lvl_of, tentative, row_key, iou_key,
                          det_valid, det_order, max_dist, max_iou, *, max_age: int):
    """K3: the per-class entry of the TPU version (single-class calls). On
    the GPU classes are concurrent blocks either way, so it launches the
    same kernel as `cascade_match_classparallel`, with its own count."""
    return _dispatch(
        cascade_match_batched,
        (gated_c, iou_c, lvl_of, tentative, row_key, iou_key, det_valid, det_order,
         max_dist, max_iou, max_age),
    )


cascade_match_classparallel.launches = 0
cascade_match_batched.launches = 0
