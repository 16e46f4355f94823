"""Optimal assignment (Jonker-Volgenant shortest augmenting path), scipy-exact.

Port of `vehicle_counting_tpu/tracking/assignment.py`: row-by-row
insertion with dual potentials, first-minimum column scans, and scipy's
transpose rule (insert the smaller side). This is the plain version the
association kernel K2 (`csrc/cascade.cu`) is held against; it runs eagerly
with Python control flow. `solve_assignment_sub_fast` and the full-matrix
`solve_assignment` route CUDA tensors to the assignment kernel K4 instead.

Contract: the [S, S] matrix is COMPACTED -- real rows first in the
reference's row order, real columns first in its column order, padding
entries BIG. Only real rows are inserted, so padding never perturbs ties.
"""

from __future__ import annotations

import numpy as np
import torch

BIG = 8.0  # >> any clamped association cost (<= ~1)
_INF = 1e18


def _insert_rows(cost: torch.Tensor, nr: int) -> torch.Tensor:
    """JV row insertion of rows [0, nr) of an [S, S] f32 matrix.

    Returns p [S+1] int64: p[j] = row assigned to column j (-1 free); index
    S is the virtual root column.
    """
    s = cost.shape[0]
    virt = s
    u = torch.zeros(s + 1, dtype=torch.float32)
    v = torch.zeros(s + 1, dtype=torch.float32)
    p = torch.full((s + 1,), -1, dtype=torch.int64)
    for i in range(int(nr)):
        p[virt] = i
        minv = torch.full((s,), _INF, dtype=torch.float32)
        way = torch.full((s,), virt, dtype=torch.int64)
        used = torch.zeros(s + 1, dtype=torch.bool)
        j0 = virt
        while int(p[j0]) != -1:
            used[j0] = True
            i0 = int(p[j0])
            cur = cost[i0] - u[i0] - v[:s]
            better = ~used[:s] & (cur < minv)
            minv = torch.where(better, cur, minv)
            way = torch.where(better, torch.full_like(way, j0), way)
            masked = torch.where(used[:s], torch.full_like(minv, _INF), minv)
            j1 = int(torch.argmin(masked))  # first minimum wins
            delta = masked[j1]
            u[p[used]] += delta  # rows of the used columns, root included
            v = torch.where(used, v - delta, v)
            minv = torch.where(used[:s], minv, minv - delta)
            j0 = j1
        while j0 != virt:  # augment along the alternating path
            j1 = int(way[j0])
            p[j0] = p[j1]
            j0 = j1
    return p


def solve_uniform(insert_fn, cost: torch.Tensor, nr: int, nc: int) -> torch.Tensor:
    """scipy-transpose handling around a row-insertion solver: when there
    are more rows than columns, insert the columns of cost.T instead.
    Returns row_to_col [S] int64, -1 for unassigned/padded rows."""
    s = cost.shape[0]
    if nr > nc:
        # p is indexed by the columns of cost.T == original rows
        return insert_fn(cost.t().contiguous(), nc)[:s]
    p = insert_fn(cost, nr)[:s]
    r2c = torch.full((s,), -1, dtype=torch.int64)
    cols = torch.nonzero(p >= 0).flatten()
    r2c[p[cols]] = cols
    return r2c


def solve_assignment_sub(cost: torch.Tensor, nr: int, nc: int) -> torch.Tensor:
    """Assignment over the top-left nr x nc submatrix of an [S, S] matrix,
    matching scipy.optimize.linear_sum_assignment including its ties."""
    return solve_uniform(_insert_rows, cost, nr, nc)


def _counts(n, device) -> torch.Tensor:
    """A row or column count as a [1] int64 tensor on `device`, made there
    (a Python int is filled in by a kernel, not copied from the host)."""
    if isinstance(n, torch.Tensor):
        return n.to(device=device, dtype=torch.int64).reshape(1)
    return torch.full((1,), int(n), dtype=torch.int64, device=device)


def solve_assignment_sub_fast(cost: torch.Tensor, nr, nc) -> torch.Tensor:
    """`solve_assignment_sub` routed by device: on the card one launch of
    the assignment kernel K4 (`ops/assignment.py::solve_uniform_batched` on
    a [1, S, S] view; it raises past S = 1023), on the CPU the plain
    solver. Equal outputs: row_to_col [S] int64, -1 unassigned."""
    if cost.device.type == "cpu":
        return solve_uniform(_insert_rows, cost, nr, nc)
    from vehicle_counting_tpu_torch.ops.assignment import solve_uniform_batched  # imports this module

    return solve_uniform_batched(cost[None], _counts(nr, cost.device), _counts(nc, cost.device))[0]


def solve_assignment(cost: torch.Tensor) -> torch.Tensor:
    """Full-matrix convenience wrapper: all N rows and all M columns of an
    [N, M] f32 cost are real. Pads to a square of side max(N, M) with BIG
    and solves it as `solve_assignment_sub_fast` does (K4 on the card, no
    host sync). Returns row_to_col [N] int64, -1 for unassigned rows."""
    n, m = cost.shape
    s = max(n, m)
    sq = torch.full((s, s), BIG, dtype=cost.dtype, device=cost.device)
    sq[:n, :m] = cost
    return solve_assignment_sub_fast(sq, n, m)[:n]


def _clamp_value(max_distance: float) -> float:
    """f32 value of max_distance + 1e-5 (min_cost_matching's clamp), as the
    JAX package's f32 arithmetic computes it."""
    return float(np.float32(float(max_distance) + 1e-5))


def matching_cost_matrix(cost: torch.Tensor, row_mask: torch.Tensor,
                         col_mask: torch.Tensor, max_distance: float) -> torch.Tensor:
    """Clamp real entries at max_distance + 1e-5 (min_cost_matching's rule,
    linear_assignment.py:58); mask the rest to BIG."""
    clamped = torch.clamp(cost, max=_clamp_value(max_distance))
    live = row_mask[:, None] & col_mask[None, :]
    return torch.where(live, clamped, torch.full_like(clamped, BIG))
