"""Batched scipy-exact assignment on compacted costs (kernel K4).

Port of the TPU kernel `ops/pallas/assignment.py::_insert_rows_pallas_batched`
(and `_insert_rows_pallas_base`, its single-problem form) into the CUDA
kernel `csrc/assignment.cu` (one thread block per problem), and of
`tracking/assignment.py::solve_uniform`, the branch-free transpose rule
around it, batched over a leading [C] axis (`solve_uniform_batched`).

The plain version is `tracking/assignment.py::_insert_rows` class by
class. The kernel is bitwise-equal to it: both do f32 subtraction and
comparison only, and both break ties at the first minimum.
"""

from __future__ import annotations

import ctypes

import torch

from vehicle_counting_tpu_torch import _build
from vehicle_counting_tpu_torch.tracking.assignment import _insert_rows

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
