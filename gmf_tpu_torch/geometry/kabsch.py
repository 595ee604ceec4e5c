"""Weighted rigid alignment (Kabsch / weighted Procrustes).

Counterpart of ``gmf_tpu/geometry/kabsch.py``:

- ``kabsch_quat`` (hot path): Horn's quaternion method. The optimal
  proper rotation is the leading eigenvector of a symmetric 4x4 matrix,
  found by Frobenius-normalised repeated squaring of the shifted matrix
  plus two matvecs. Batched small matmuls, no host round trip, and no
  reflections by construction.
- ``kabsch_svd``: the SVD form, kept as the cross-check.
"""

from __future__ import annotations

import math

import torch

from gmf_tpu_torch.geometry.se3 import integrate_trans

_EPS = 1e-6


def _weighted_cross_covariance(A, B, weights):
    """(H = Am^T diag(w) Bm [..., 3, 3], cA [..., 3], cB [..., 3])."""
    wsum = weights.sum(-1, keepdim=True)
    cA = (A * weights[..., None]).sum(-2) / (wsum + _EPS)
    cB = (B * weights[..., None]).sum(-2) / (wsum + _EPS)
    Am = A - cA[..., None, :]
    Bm = B - cB[..., None, :]
    H = torch.matmul((Am * weights[..., None]).transpose(-1, -2), Bm)
    return H, cA, cB


def _horn_quaternion_matrix(H):
    """Horn's symmetric 4x4 matrix from the cross-covariance H."""
    Sxx, Sxy, Sxz = H[..., 0, 0], H[..., 0, 1], H[..., 0, 2]
    Syx, Syy, Syz = H[..., 1, 0], H[..., 1, 1], H[..., 1, 2]
    Szx, Szy, Szz = H[..., 2, 0], H[..., 2, 1], H[..., 2, 2]
    rows = [
        [Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx],
        [Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz],
        [Szx - Sxz, Sxy + Syx, Syy - Sxx - Szz, Syz + Szy],
        [Sxy - Syx, Szx + Sxz, Syz + Szy, Szz - Sxx - Syy],
    ]
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def quat_to_rotmat(q):
    """Unit quaternion [..., 4] (w, x, y, z) -> rotation [..., 3, 3]."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rows = [
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ]
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def _leading_eigvec_4x4(N, num_iters: int = 40):
    """Leading eigenvector of symmetric 4x4 matrices by shifted power
    iteration, as repeated squaring: max(2, ceil(log2 num_iters) + 1)
    normalised squarings (7 at 40), then two matvecs."""
    sigma = N.abs().sum(-1).amax(-1)  # Gershgorin bound on |lambda|
    eye = torch.eye(4, dtype=N.dtype, device=N.device)
    M = N + (sigma[..., None, None] + 1.0) * eye
    v = torch.ones(N.shape[:-1], dtype=N.dtype, device=N.device)
    squarings = max(2, int(math.ceil(math.log2(max(2, num_iters)))) + 1)
    for _ in range(squarings):
        M = torch.matmul(M, M)
        M = M / (torch.linalg.matrix_norm(M, keepdim=True) + _EPS)
    for _ in range(2):
        v = torch.matmul(M, v[..., None])[..., 0]
        v = v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True) + _EPS)
    return v


def kabsch_quat(A, B, weights=None, num_iters: int = 40):
    """[..., 4, 4] T with B ~ transform(A, T), via Horn quaternions."""
    if weights is None:
        weights = torch.ones(A.shape[:-1], dtype=A.dtype, device=A.device)
    H, cA, cB = _weighted_cross_covariance(A, B, weights)
    q = _leading_eigvec_4x4(_horn_quaternion_matrix(H), num_iters=num_iters)
    R = quat_to_rotmat(q)
    t = cB - torch.matmul(R, cA[..., None])[..., 0]
    return integrate_trans(R, t)


def kabsch_svd(A, B, weights=None):
    """Weighted Kabsch via SVD, with the det-based reflection fix."""
    if weights is None:
        weights = torch.ones(A.shape[:-1], dtype=A.dtype, device=A.device)
    H, cA, cB = _weighted_cross_covariance(A, B, weights)
    U, _, Vh = torch.linalg.svd(H)
    V = Vh.transpose(-1, -2)
    Ut = U.transpose(-1, -2)
    det = torch.linalg.det(torch.matmul(V, Ut))
    D = torch.cat([torch.ones(H.shape[:-2] + (2,), dtype=H.dtype,
                              device=H.device), det[..., None]], -1)
    R = torch.matmul(V * D[..., None, :], Ut)
    t = cB - torch.matmul(R, cA[..., None])[..., 0]
    return integrate_trans(R, t)


def rigid_transform_3d(A, B, weights=None, weight_threshold: float = 0.0,
                       method: str = "quat"):
    """Weighted Procrustes, weights below ``weight_threshold`` clipped to
    zero first (gmf_tpu/geometry/kabsch.py:167-182). ``method``: "quat"
    (hot path) or "svd"."""
    if weights is not None and weight_threshold > 0.0:
        weights = torch.where(weights < weight_threshold,
                              torch.zeros_like(weights), weights)
    if method == "quat":
        return kabsch_quat(A, B, weights)
    if method == "svd":
        return kabsch_svd(A, B, weights)
    raise ValueError(f"unknown method {method!r}")
