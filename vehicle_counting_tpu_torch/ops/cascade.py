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

Outputs (`CascadeOut`): det_free [C, K] bool, det_key [C, K] i32
(unmatched-list order keys that decide new track ids), out_row [C, K] i32
(detection slot -> matched track slot, -1 none) and track_col [C, K] i32
(track slot -> matched detection slot, -1 none). The kernel is
bitwise-equal to the plain version: its arithmetic is f32 subtraction and
comparison only.

The launch is shaped to be a node of a captured CUDA graph: operands are
read in the dtypes the tracker holds them in (bool as bytes; the wrapper
checks and never casts), the outputs are written in the dtypes the tracker
reads, and the kernel's one-time set-up is made at first use on each
device, outside any launch.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from vehicle_counting_tpu_torch import _build
from vehicle_counting_tpu_torch.tracking.assignment import _clamp_value, matching_cost_matrix, solve_assignment_sub

IMAX = 2147483647
# The kernel's own limits: one slot per thread plus the root column; order
# keys are ranked before they are packed, so any int32 key does, as long as
# the demoted keys, which reach (max_age + 2) * K, stay in int32. The
# tracker's routing (`tracking/tracker.py::_use_cascade_kernel`) is
# narrower: it keeps the TPU kernel's gates.
MAX_K = 1023


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
    c = matching_cost_matrix(cost, rows, det_free, threshold)
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
    """Plain version of the kernel: `associate_plain` class by class.
    track_col is the staged association's own; out_row is its inverse."""
    c, k, _ = gated_c.shape
    out = _out_buffers(c, k, gated_c.device)
    out.out_row.fill_(-1)
    for ci in range(c):
        free, track_col, key = associate_plain(
            gated_c[ci].float(), iou_c[ci].float(), lvl_of[ci].to(torch.int32),
            tentative[ci].bool(), row_key[ci].to(torch.int32), iou_key[ci].to(torch.int32),
            det_valid[ci].bool(), det_order[ci].to(torch.int32), max_dist, max_iou, max_age,
        )
        out.det_free[ci] = free
        out.det_key[ci] = key
        out.track_col[ci] = track_col
        matched = torch.nonzero(track_col >= 0).flatten()
        out.out_row[ci, track_col[matched].long()] = matched.to(torch.int32)
    return out


class CascadeOut(NamedTuple):
    """What one association leaves, all [C, K]."""

    det_free: torch.Tensor   # bool: detection still unmatched
    det_key: torch.Tensor    # i32 unmatched-list order key
    out_row: torch.Tensor    # i32 detection slot -> matched track slot (-1 none)
    track_col: torch.Tensor  # i32 track slot -> matched detection slot (-1 none)


def _out_buffers(c: int, k: int, device) -> CascadeOut:
    i32 = dict(dtype=torch.int32, device=device)
    return CascadeOut(torch.empty((c, k), dtype=torch.bool, device=device), torch.empty((c, k), **i32),
                      torch.empty((c, k), **i32), torch.empty((c, k), **i32))


_ARGTYPES = (
    [ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.c_int]
    + [ctypes.c_float] * 4 + [ctypes.c_int] + [ctypes.c_void_p] * 6
)
_OPERAND_DTYPES = (("lvl_of", torch.int32), ("tentative", torch.bool), ("row_key", torch.int32),
                   ("iou_key", torch.int32), ("det_valid", torch.bool), ("det_order", torch.int32))
_prepared = set()  # device indices whose shared-memory limit is raised


def _entry(dev):
    """The kernel's C entry. At its first use the library is built, and at
    the first use on each device the kernel's shared-memory limit is raised
    there: a launch itself configures nothing, so it can be a node of a
    captured graph."""
    index = torch.cuda.current_device() if dev.index is None else dev.index
    if index not in _prepared:
        with torch.cuda.device(index):
            _build.check(_build.entry("cascade", "vct_cascade_prepare", [])(), "cascade association kernel set-up")
        _prepared.add(index)
    return _build.entry("cascade", "vct_cascade_match", _ARGTYPES)


def _launch(gated_c, iou_c, lvl_of, tentative, row_key, iou_key, det_valid,
            det_order, max_dist, max_iou, max_age, prof=None):
    """Check the operands and launch the CUDA kernel: one block per class.
    The kernel reads every operand in the dtype the tracker holds it in
    (bool as bytes), so nothing is cast or copied here."""
    dev = gated_c.device
    c, k, k2 = gated_c.shape
    if k != k2 or iou_c.shape != (c, k, k):
        raise ValueError(f"cost matrices must be [C, K, K], got {tuple(gated_c.shape)} and {tuple(iou_c.shape)}")
    if k > MAX_K:
        raise ValueError(f"association kernel takes K <= {MAX_K}, got {k}")
    if (max_age + 2) * k > IMAX:
        raise ValueError(f"(max_age + 2) * K = {(max_age + 2) * k} exceeds the int32 range of the detection keys")
    for name, t in (("gated_c", gated_c), ("iou_c", iou_c)):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"{name} must be contiguous float32 on {dev}, got {t.dtype} on {t.device}")
    vecs = (lvl_of, tentative, row_key, iou_key, det_valid, det_order)
    for (name, dtype), t in zip(_OPERAND_DTYPES, vecs):
        if t.shape != (c, k) or t.device != dev or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous {dtype} [C, K] on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    out = _out_buffers(c, k, dev)
    rc = _entry(dev)(
        gated_c.data_ptr(), iou_c.data_ptr(), *(t.data_ptr() for t in vecs),
        c, k,
        float(np.float32(max_dist)), float(np.float32(max_iou)),
        _clamp_value(max_dist), _clamp_value(max_iou), int(max_age),
        out.out_row.data_ptr(), out.det_free.data_ptr(), out.det_key.data_ptr(), out.track_col.data_ptr(),
        0 if prof is None else prof.data_ptr(), _build.current_stream(dev),
    )
    _build.check(rc, "cascade association kernel")
    return out


PROF_SECTIONS = ("load", "level_walk", "stage_ranks", "stage_insert", "stage_accept", "store", "total", "stages")


def cascade_clock_split(*args, max_age: int):
    """One launch of the kernel's instrumented variant on CUDA operands
    (those of `cascade_match_classparallel`): {section: clock64 ticks of
    thread 0, summed over classes}, "stages" the non-empty stages run. For
    measurement only; it counts as no launch of the main path."""
    c = args[0].shape[0]
    words = _build.entry("cascade", "vct_cascade_prof_words", [])()
    prof = torch.zeros((c, words), dtype=torch.int64, device=args[0].device)
    _launch(*args, max_age, prof=prof)
    return dict(zip(PROF_SECTIONS, prof.sum(0).tolist()))


def _dispatch(wrapper, args):
    if args[0].device.type == "cpu":
        return _cascade_plain(*args)
    if args[0].device.type != "cuda":
        raise ValueError(f"unsupported device {args[0].device}")
    res = _launch(*args)
    wrapper.launches += 1
    return res


def cascade_match_classparallel(gated_c, iou_c, lvl_of, tentative, row_key, iou_key,
                                det_valid, det_order, max_dist, max_iou, *, max_age: int) -> CascadeOut:
    """K2: full cascade + IoU association for [C] classes in one launch.

    Args (all leading [C], contiguous): gated_c [C, K, K] f32 cascade cost
    (appearance with Mahalanobis gating, BIG at invalid detections), iou_c
    [C, K, K] f32 IoU cost (tsu > 1 rows at INFTY), lvl_of [C, K] i32
    cascade level per track slot (IMAX when not participating), tentative
    [C, K] bool, row_key / iou_key [C, K] i32 cascade / IoU row order keys
    (ranked stably in the kernel), det_valid [C, K] bool, det_order [C, K]
    i32 initial unmatched-list keys.
    Returns CascadeOut(det_free bool, det_key i32, out_row i32, track_col i32).
    """
    return _dispatch(
        cascade_match_classparallel,
        (gated_c, iou_c, lvl_of, tentative, row_key, iou_key, det_valid, det_order,
         max_dist, max_iou, max_age),
    )


def cascade_match_batched(gated_c, iou_c, lvl_of, tentative, row_key, iou_key,
                          det_valid, det_order, max_dist, max_iou, *, max_age: int) -> CascadeOut:
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
