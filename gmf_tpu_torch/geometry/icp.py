"""Fixed-iteration ICP (point-to-point and point-to-plane), in PyTorch.

Counterpart of ``gmf_tpu/geometry/icp.py``, which replaces the
reference's Open3D ICP polish (evaluation/benchmark_utils.py:40-56
``icp_refine``): a fixed number of iterations from an initial transform,
each a dense nearest neighbour over the [N, M] squared distances (no
KD-tree; 576 MB at 12000 x 12000 in f32) and a weighted Kabsch on the
matches within ``max_corr_dist``. Every step stays on the points' device
without a host sync (a degenerate step keeps T through ``torch.where``).
Products are f32 with TF32 off (``utils/device.py``), as the reference
runs them at full precision.
"""

from __future__ import annotations

import torch

from gmf_tpu_torch.geometry.kabsch import rigid_transform_3d


def _valid(mask, n, like):
    return (torch.ones(n, dtype=like.dtype, device=like.device)
            if mask is None else mask.to(like.dtype))


def _nearest(warped, tgt, t2, tgt_valid):
    """Index and squared distance of each warped point's nearest valid
    target point."""
    d2 = ((warped * warped).sum(-1)[:, None] - 2.0 * warped @ tgt.T
          + t2[None, :])
    d2 = torch.where(tgt_valid[None, :] > 0, d2,
                     torch.full_like(d2, float("inf")))
    nn = torch.argmin(d2, dim=-1)
    return nn, d2.gather(1, nn[:, None])[:, 0]


def icp_refine(src, tgt, init_trans, max_corr_dist: float = 0.10,
               num_iters: int = 20, src_mask=None, tgt_mask=None):
    """Point-to-point ICP: src [N, 3], tgt [M, 3], init_trans [4, 4] ->
    refined [4, 4]. An iteration with fewer than 3 matches keeps T."""
    tgt_valid = _valid(tgt_mask, tgt.shape[0], src)
    src_valid = _valid(src_mask, src.shape[0], src)
    t2 = (tgt * tgt).sum(-1)
    T = init_trans.to(src.dtype)
    for _ in range(num_iters):
        warped = src @ T[:3, :3].T + T[:3, 3]
        nn, nn_d2 = _nearest(warped, tgt, t2, tgt_valid)
        w = (nn_d2 < max_corr_dist ** 2).to(src.dtype) * src_valid
        T = torch.where(
            w.sum() >= 3.0,
            rigid_transform_3d(src[None], tgt[nn][None], w[None])[0], T)
    return T


def _so3_exp(w):
    """Rodrigues: [3] axis-angle -> [3, 3] rotation (finite at w = 0)."""
    th2 = (w * w).sum()
    th = torch.sqrt(th2 + 1e-24)
    zero = torch.zeros((), dtype=w.dtype, device=w.device)
    K = torch.stack([torch.stack([zero, -w[2], w[1]]),
                     torch.stack([w[2], zero, -w[0]]),
                     torch.stack([-w[1], w[0], zero])])
    A = torch.sinc(th / torch.pi)  # sin(th) / th
    B = torch.where(th2 > 1e-12,
                    (1.0 - torch.cos(th)) / torch.clamp(th2, min=1e-24),
                    torch.full_like(th2, 0.5))
    return torch.eye(3, dtype=w.dtype, device=w.device) + A * K + B * (K @ K)


def icp_point_to_plane(src, tgt, tgt_normals, init_trans,
                       max_corr_dist: float = 0.10, num_iters: int = 20,
                       src_mask=None, tgt_mask=None):
    """Point-to-plane ICP: minimises sum w ((R p + t - q) . n_q)^2 with the
    small-angle 6x6 normal equations (J = [p x n ; n], Levenberg damping)
    and a Rodrigues retraction; a step that is degenerate (fewer than 6
    matches) or not finite keeps T."""
    tgt_valid = _valid(tgt_mask, tgt.shape[0], src)
    src_valid = _valid(src_mask, src.shape[0], src)
    t2 = (tgt * tgt).sum(-1)
    eye6 = torch.eye(6, dtype=src.dtype, device=src.device)
    T = init_trans.to(src.dtype)
    for _ in range(num_iters):
        warped = src @ T[:3, :3].T + T[:3, 3]
        nn, nn_d2 = _nearest(warped, tgt, t2, tgt_valid)
        w = (nn_d2 < max_corr_dist ** 2).to(src.dtype) * src_valid
        n = tgt_normals[nn]
        r = ((warped - tgt[nn]) * n).sum(-1)
        J = torch.cat([torch.linalg.cross(warped, n), n], dim=-1)
        Jw = J * w[:, None]
        H = J.T @ Jw
        H = H + 1e-6 * torch.trace(H) / 6.0 * eye6
        xi = torch.linalg.solve(H, -(Jw.T @ r))
        dT = torch.eye(4, dtype=src.dtype, device=src.device)
        dT[:3, :3] = _so3_exp(xi[:3])
        dT[:3, 3] = xi[3:]
        T_new = dT @ T
        ok = (w.sum() >= 6.0) & torch.isfinite(T_new).all()
        T = torch.where(ok, T_new, T)
    return T
