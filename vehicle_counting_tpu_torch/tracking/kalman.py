"""Batched constant-velocity Kalman filter for DeepSORT track state.

Port of `vehicle_counting_tpu/tracking/kalman.py` (reference
networks/deepsort/sort/kalman_filter.py): 8-d state (cx, cy, a, h, vx,
vy, va, vh), dt = 1, observation (cx, cy, a, h), noise relative to box
height (std_weight_position 1/20, std_weight_velocity 1/160), chi-square
95% gate for 4 dof. Batched over any leading dims. The 4x4 Cholesky and
the triangular solves are unrolled in the reference's operation order; on
the GPU they are elementwise ops with no host sync (torch.linalg.cholesky
checks its result on the host).
"""

from __future__ import annotations

import torch

STD_W_POS = 1.0 / 20
STD_W_VEL = 1.0 / 160
CHI2INV95_4DOF = 9.4877


def _cholesky4(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of SPD [..., 4, 4] matrices (LAPACK potrf order)."""
    l00 = torch.sqrt(a[..., 0, 0])
    l10 = a[..., 1, 0] / l00
    l20 = a[..., 2, 0] / l00
    l30 = a[..., 3, 0] / l00
    l11 = torch.sqrt(a[..., 1, 1] - l10 * l10)
    l21 = (a[..., 2, 1] - l20 * l10) / l11
    l31 = (a[..., 3, 1] - l30 * l10) / l11
    l22 = torch.sqrt(a[..., 2, 2] - l20 * l20 - l21 * l21)
    l32 = (a[..., 3, 2] - l30 * l20 - l31 * l21) / l22
    l33 = torch.sqrt(a[..., 3, 3] - l30 * l30 - l31 * l31 - l32 * l32)
    z = torch.zeros_like(l00)
    return torch.stack(
        [
            torch.stack([l00, z, z, z], -1),
            torch.stack([l10, l11, z, z], -1),
            torch.stack([l20, l21, l22, z], -1),
            torch.stack([l30, l31, l32, l33], -1),
        ],
        -2,
    )


def _trisolve4(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve L x = b, L lower-triangular [..., 4, 4], b [..., 4, N]."""
    x0 = b[..., 0, :] / l[..., 0, 0, None]
    x1 = (b[..., 1, :] - l[..., 1, 0, None] * x0) / l[..., 1, 1, None]
    x2 = (b[..., 2, :] - l[..., 2, 0, None] * x0 - l[..., 2, 1, None] * x1) / l[..., 2, 2, None]
    x3 = (b[..., 3, :] - l[..., 3, 0, None] * x0 - l[..., 3, 1, None] * x1
          - l[..., 3, 2, None] * x2) / l[..., 3, 3, None]
    return torch.stack([x0, x1, x2, x3], -2)


def _trisolve4_upper(u: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve U x = b, U upper-triangular [..., 4, 4] (back substitution)."""
    x3 = b[..., 3, :] / u[..., 3, 3, None]
    x2 = (b[..., 2, :] - u[..., 2, 3, None] * x3) / u[..., 2, 2, None]
    x1 = (b[..., 1, :] - u[..., 1, 2, None] * x2 - u[..., 1, 3, None] * x3) / u[..., 1, 1, None]
    x0 = (b[..., 0, :] - u[..., 0, 1, None] * x1 - u[..., 0, 2, None] * x2
          - u[..., 0, 3, None] * x3) / u[..., 0, 0, None]
    return torch.stack([x0, x1, x2, x3], -2)


def _diag(std: torch.Tensor) -> torch.Tensor:
    return torch.diag_embed(torch.square(std))


def initiate(measurement: torch.Tensor):
    """measurement [..., 4] xyah -> (mean [..., 8], cov [..., 8, 8])."""
    m = measurement
    mean = torch.cat([m, torch.zeros_like(m)], -1)
    h = m[..., 3]
    std = torch.stack(
        [2 * STD_W_POS * h, 2 * STD_W_POS * h, torch.full_like(h, 1e-2), 2 * STD_W_POS * h,
         10 * STD_W_VEL * h, 10 * STD_W_VEL * h, torch.full_like(h, 1e-5), 10 * STD_W_VEL * h],
        -1,
    )
    return mean, _diag(std)


def predict(mean: torch.Tensor, cov: torch.Tensor):
    """mean [..., 8], cov [..., 8, 8] -> one constant-velocity step; the
    process noise is built from the CURRENT height."""
    h = mean[..., 3]
    std = torch.stack(
        [STD_W_POS * h, STD_W_POS * h, torch.full_like(h, 1e-2), STD_W_POS * h,
         STD_W_VEL * h, STD_W_VEL * h, torch.full_like(h, 1e-5), STD_W_VEL * h],
        -1,
    )
    # F = [[I, I], [0, I]]: F m and F P F^T as block sums
    new_mean = torch.cat([mean[..., :4] + mean[..., 4:], mean[..., 4:]], -1)
    fp = torch.cat([cov[..., :4, :] + cov[..., 4:, :], cov[..., 4:, :]], -2)
    fpf = torch.cat([fp[..., :, :4] + fp[..., :, 4:], fp[..., :, 4:]], -1)
    return new_mean, fpf + _diag(std)


def project(mean: torch.Tensor, cov: torch.Tensor):
    """State -> measurement space with innovation noise R."""
    h = mean[..., 3]
    std = torch.stack([STD_W_POS * h, STD_W_POS * h, torch.full_like(h, 1e-1), STD_W_POS * h], -1)
    return mean[..., :4], cov[..., :4, :4] + _diag(std)


def update(mean: torch.Tensor, cov: torch.Tensor, measurement: torch.Tensor):
    """Kalman correction; measurement [..., 4] xyah."""
    z, s = project(mean, cov)
    chol = _cholesky4(s)
    rhs = cov[..., :, :4].transpose(-1, -2)  # (P H^T)^T [..., 4, 8]
    x = _trisolve4_upper(chol.transpose(-1, -2), _trisolve4(chol, rhs))
    gain = x.transpose(-1, -2)  # [..., 8, 4]
    innov = measurement - z
    new_mean = mean + torch.einsum("...ij,...j->...i", gain, innov)
    new_cov = cov - torch.einsum("...ij,...jk,...lk->...il", gain, s, gain)
    return new_mean, new_cov


def gating_distance(mean: torch.Tensor, cov: torch.Tensor, measurements: torch.Tensor):
    """Squared Mahalanobis distance [..., K, D] of measurements [..., D, 4]
    to tracks (mean [..., K, 8], cov [..., K, 8, 8])."""
    z, s = project(mean, cov)
    chol = _cholesky4(s)  # [..., K, 4, 4]
    d = measurements[..., None, :, :] - z[..., :, None, :]  # [..., K, D, 4]
    zsol = _trisolve4(chol, d.transpose(-1, -2))  # [..., K, 4, D]
    return torch.sum(torch.square(zsol), -2)


def to_tlwh(mean: torch.Tensor) -> torch.Tensor:
    """Track state xyah -> tlwh."""
    cx, cy, a, h = mean[..., 0], mean[..., 1], mean[..., 2], mean[..., 3]
    w = a * h
    return torch.stack([cx - w / 2, cy - h / 2, w, h], -1)
