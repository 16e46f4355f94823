"""Batched scipy-exact assignment on compacted costs (kernel K4).

Port of the TPU kernel `ops/pallas/assignment.py::_insert_rows_pallas_batched`
(and `_insert_rows_pallas_base`, its single-problem form) into the CUDA
kernel `csrc/assignment.cu` (one thread block per problem), and of
`tracking/assignment.py::solve_uniform`, the branch-free transpose rule
around it, batched over a leading [C] axis (`solve_uniform_batched`).

The plain version is `tracking/assignment.py::_insert_rows` class by
class. The kernel is bitwise-equal to it: both do f32 subtraction and
comparison only, and both break ties at the first minimum.

`match_stage_batched` is the staged route's whole matching stage
(one pass of `tracking/tracker.py::_associate_staged`) as ONE launch of the same source's
second entry, `vct_match_stage`: ranks, transpose rule, insertion, accept /
reject and demotion on the uncompacted [C, K, K] cost, in place on the
stage's three state vectors. Its plain version is `match_stage_plain`, the
compacting torch form around `solve_uniform_batched`.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from vehicle_counting_tpu_torch import _build
from vehicle_counting_tpu_torch.ops.cascade import IMAX, _clamp_value
from vehicle_counting_tpu_torch.tracking.assignment import BIG, _insert_rows

MAX_S = 1023  # one column per thread, plus the root column, in 1024 threads


def insert_rows_plain(costs: torch.Tensor, n_ins: torch.Tensor) -> torch.Tensor:
    """Plain version of K4: `_insert_rows` problem by problem -> [C, S+1] i32.
    n_ins is clamped to [0, S], as in the kernel."""
    c, s, _ = costs.shape
    out = torch.empty((c, s + 1), dtype=torch.int32)
    for ci, n in enumerate(n_ins.tolist()):
        out[ci] = _insert_rows(costs[ci].float(), min(max(int(n), 0), s)).to(torch.int32)
    return out


_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]


def _launch(costs: torch.Tensor, n_ins: torch.Tensor) -> torch.Tensor:
    """Check the operands and launch the CUDA kernel: one block per problem."""
    if costs.dim() != 3 or costs.shape[1] != costs.shape[2]:
        raise ValueError(f"costs must be [C, S, S], got {tuple(costs.shape)}")
    c, s, _ = costs.shape
    if s > MAX_S:
        raise ValueError(f"assignment kernel takes S <= {MAX_S} (one column per thread), got {s}")
    if costs.dtype != torch.float32:
        raise ValueError(f"costs must be float32, got {costs.dtype}")
    if n_ins.shape != (c,) or n_ins.device != costs.device:
        raise ValueError(f"n_ins must be [C] on {costs.device}, got {tuple(n_ins.shape)} on {n_ins.device}")
    costs = costs.contiguous()
    n = n_ins.to(torch.int32).contiguous()
    out = torch.empty((c, s + 1), dtype=torch.int32, device=costs.device)
    fn = _build.entry("assignment", "vct_insert_rows", _ARGTYPES)
    rc = fn(costs.data_ptr(), n.data_ptr(), c, s, out.data_ptr(), _build.current_stream(costs.device))
    _build.check(rc, "assignment kernel")
    return out


def insert_rows_batched(costs: torch.Tensor, n_ins: torch.Tensor) -> torch.Tensor:
    """K4: JV row insertion of rows [0, n_ins[c]) of each [S, S] f32 cost.

    costs [C, S, S] compacted (real rows and columns first, padding BIG),
    n_ins [C] int. Returns p [C, S+1] i32: p[c, j] = row assigned to
    column j (-1 free), p[c, S] the root. CPU tensors take the plain
    version; CUDA tensors launch the kernel of `csrc/assignment.cu` or raise.
    """
    if costs.device.type == "cpu":
        return insert_rows_plain(costs, n_ins)
    if costs.device.type != "cuda":
        raise ValueError(f"unsupported device {costs.device}")
    out = _launch(costs, n_ins)
    insert_rows_batched.launches += 1
    return out


insert_rows_batched.launches = 0


def solve_uniform_batched(costs: torch.Tensor, nr: torch.Tensor, nc: torch.Tensor) -> torch.Tensor:
    """Assignment over the top-left nr[c] x nc[c] block of each [S, S] cost,
    scipy's transpose rule as a data select: where nr > nc the columns of
    cost.T are inserted. One `insert_rows_batched` call (one K4 launch on
    the card) for all problems, no host sync.
    Returns row_to_col [C, S] int64, -1 for unassigned or padded rows."""
    c, s, _ = costs.shape
    flip = nr > nc
    mat = torch.where(flip[:, None, None], costs.transpose(1, 2), costs)
    p = insert_rows_batched(mat, torch.where(flip, nc, nr))[:, :s].long()  # col -> row of the inserted side
    # normal: invert col -> row; p's assigned entries are distinct rows
    r2c = torch.full((c, s + 1), -1, dtype=torch.int64, device=costs.device)
    cols = torch.arange(s, device=costs.device).expand(c, s).contiguous()
    r2c.scatter_(1, torch.where(p >= 0, p, s), cols)
    # flipped: p is indexed by cost.T's columns == original rows, so p IS r2c
    return torch.where(flip[:, None], p, r2c[:, :s])


def match_stage_plain(cost, rows, det_free, track_col, threshold, row_order, det_key, stage_base):
    """Plain version of `match_stage_batched`: one min_cost_matching pass
    for [C] classes at once (all [C, K]), out of place.

    Counterpart of the JAX `tracker.py::_match_stage`: rows and free
    detections are ranked stably and the clamped cost compacted with
    gathers (exact), so the solver sees the reference's row and column
    orders; one `solve_uniform_batched` call solves every class. Rejected
    matches demote their detection to stage_base * K + (rejection rank in
    row order); stage_base is [C]. A class with no row or no free detection
    is left as it was. Returns (det_free, track_col, det_key).
    """
    c, k = rows.shape
    dev = rows.device
    nr = rows.sum(-1)
    nc = det_free.sum(-1)
    do = (nr > 0) & (nc > 0)
    nr, nc = torch.where(do, nr, 0), torch.where(do, nc, 0)  # a no-op inserts nothing
    imax = torch.full_like(row_order, IMAX)
    row_perm = torch.argsort(torch.where(rows, row_order, imax), dim=-1, stable=True)
    col_perm = torch.argsort(torch.where(det_free, det_key, imax), dim=-1, stable=True)
    live = rows[:, :, None] & det_free[:, None, :]
    clamped = torch.clamp(cost, max=_clamp_value(threshold))
    cm = torch.where(live, clamped, torch.full_like(clamped, BIG))
    c2 = torch.gather(cm, 1, row_perm[:, :, None].expand(c, k, k))
    c2 = torch.gather(c2, 2, col_perm[:, None, :].expand(c, k, k))
    r2c = solve_uniform_batched(c2, nr, nc)  # permuted row -> permuted col

    a = torch.arange(k, device=dev)
    paired = (a < nr[:, None]) & (r2c >= 0) & (r2c < nc[:, None])
    r2c_c = torch.clamp(r2c, 0, k - 1)
    cost_at = torch.gather(c2, 2, r2c_c[:, :, None])[:, :, 0]
    accept = paired & (cost_at <= np.float32(threshold))
    reject = paired & ~accept
    slot_col = torch.gather(col_perm, 1, r2c_c)

    def put(dst, idx, mask, val):  # dst[c, idx] = val where mask; k is a dump slot
        ext = torch.cat([dst, dst[:, :1]], 1)
        ext.scatter_(1, torch.where(mask, idx, k), val.to(dst.dtype))
        return ext[:, :k]

    track_col = put(track_col, row_perm, accept, slot_col)
    det_free = put(det_free, slot_col, accept, torch.zeros_like(accept))
    rank = torch.cumsum(reject.to(torch.int64), -1) - 1
    det_key = put(det_key, slot_col, reject, stage_base[:, None] * k + rank)
    return det_free, track_col, det_key


_STAGE_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
_STAGE_DTYPES = (("rows", torch.bool), ("det_free", torch.bool), ("track_col", torch.int32),
                 ("row_order", torch.int32), ("det_key", torch.int32))


def _launch_stage(cost, rows, det_free, track_col, threshold, row_order, det_key, stage_base):
    """Check the operands and launch `vct_match_stage`: one block per class."""
    dev = cost.device
    if cost.dim() != 3 or cost.shape[1] != cost.shape[2]:
        raise ValueError(f"cost must be [C, K, K], got {tuple(cost.shape)}")
    c, k, _ = cost.shape
    if k > MAX_S:
        raise ValueError(f"assignment kernel takes K <= {MAX_S} (one column per thread), got {k}")
    if cost.dtype != torch.float32 or not cost.is_contiguous():
        raise ValueError(f"cost must be contiguous float32, got {cost.dtype}")
    for (name, dtype), t in zip(_STAGE_DTYPES, (rows, det_free, track_col, row_order, det_key)):
        if t.shape != (c, k) or t.device != dev or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous {dtype} [C, K] on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if stage_base.shape != (c,) or stage_base.device != dev or stage_base.dtype != torch.int32 \
            or not stage_base.is_contiguous():
        raise ValueError(f"stage_base must be contiguous int32 [C] on {dev}, got {stage_base.dtype} "
                         f"{tuple(stage_base.shape)} on {stage_base.device}")
    fn = _build.entry("assignment", "vct_match_stage", _STAGE_ARGTYPES)
    rc = fn(cost.data_ptr(), rows.data_ptr(), det_free.data_ptr(), row_order.data_ptr(), det_key.data_ptr(),
            track_col.data_ptr(), stage_base.data_ptr(), c, k, float(np.float32(threshold)),
            _clamp_value(threshold), _build.current_stream(dev))
    _build.check(rc, "matching stage kernel")


def match_stage_batched(cost, rows, det_free, track_col, threshold, row_order, det_key, stage_base):
    """K4, the fused stage: one min_cost_matching pass for [C] classes in
    one launch. cost [C, K, K] f32 (unclamped), rows / det_free [C, K] bool,
    track_col / row_order / det_key [C, K] i32, stage_base [C] (i32 on the
    card). Returns (det_free, track_col, det_key).

    CUDA tensors launch `vct_match_stage` of `csrc/assignment.cu` or raise:
    det_free, track_col and det_key are UPDATED IN PLACE and returned, so
    the caller must own them. CPU tensors take `match_stage_plain`, which
    returns new tensors.
    """
    if cost.device.type == "cpu":
        return match_stage_plain(cost, rows, det_free, track_col, threshold, row_order, det_key, stage_base)
    if cost.device.type != "cuda":
        raise ValueError(f"unsupported device {cost.device}")
    _launch_stage(cost, rows, det_free, track_col, threshold, row_order, det_key, stage_base)
    match_stage_batched.launches += 1
    return det_free, track_col, det_key


match_stage_batched.launches = 0
