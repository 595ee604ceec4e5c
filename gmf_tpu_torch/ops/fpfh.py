"""FPFH descriptors in PyTorch (Open3D's role), on the points' device.

Counterpart of ``gmf_tpu/ops/fpfh.py``, which computes them in plain
``jnp`` (no Pallas kernel), as the port does in plain PyTorch. The
reference computes Open3D normals (hybrid radius search, max_nn 30) and
FPFH features (max_nn 100), then L2-normalizes and NaN-scrubs
(GMF_DGR_fpfh core/trainer.py:659-697):

- fixed-K neighbourhoods: a radius-masked kNN over dense distances, in
  chunks of rows, the k nearest in ``jax.lax.top_k``'s order (ties to the
  lower index, ``geometry/nms.py::topk_total_order``);
- normals: the local covariance's smallest eigenvector by power
  iteration on (tr(C) I - C), oriented towards the origin;
- the Darboux-frame triplet (alpha, phi, theta) in 11 bins each, 33 dims.

A value on a bin's edge may land in the neighbouring bin when its last
bit differs from the JAX package's (tests/test_torch_dgr.py bounds it).
"""

from __future__ import annotations

import math

import torch

from gmf_tpu_torch.geometry.nms import topk_total_order


def _radius_knn(xyz, radius: float, k: int, mask=None, chunk: int = 2048):
    """(idx [N, k] int64, valid [N, k] bool, dist [N, k]) of up to k
    neighbours within ``radius`` (self excluded), nearest first."""
    N = xyz.shape[0]
    k = min(k, max(N - 1, 1))  # tiny clouds: never more than N - 1
    sq = (xyz * xyz).sum(-1)
    idx, d2 = [], []
    for s in range(0, N, chunk):
        x = xyz[s:s + chunk]
        d = sq[s:s + chunk, None] - 2.0 * (x @ xyz.T) + sq[None, :]
        rows = torch.arange(x.shape[0], device=xyz.device)
        d[rows, rows + s] = math.inf
        if mask is not None:
            d = torch.where(mask[None, :] > 0, d, torch.full_like(d, math.inf))
        i = topk_total_order(-d, k)
        idx.append(i)
        d2.append(d.gather(1, i))
    idx, d2 = torch.cat(idx), torch.cat(d2)
    return idx, d2 <= radius * radius, torch.sqrt(torch.clamp(d2, min=0.0))


def estimate_normals(xyz, radius: float = 0.10, max_nn: int = 30,
                     mask=None):
    """Per-point normals [N, 3]: PCA over up to ``max_nn`` neighbours
    within ``radius`` (with the point itself), oriented to the origin."""
    idx, valid, _ = _radius_knn(xyz, radius, max_nn, mask)
    nbr = xyz[idx]  # [N, k, 3]
    w = valid.to(xyz.dtype)[..., None]
    cnt = w.sum(1) + 1.0  # + self
    mean = ((nbr * w).sum(1) + xyz) / cnt
    d = (nbr - mean[:, None, :]) * w
    C = torch.einsum("nki,nkj->nij", d, d)
    d_self = xyz - mean
    C = C + d_self[:, :, None] * d_self[:, None, :]
    # largest eigenvector of (tr(C) I - C) == smallest of C; 4 normalized
    # squarings then 8 steps (an effective 128-step power iteration)
    tr = C.diagonal(dim1=-2, dim2=-1).sum(-1)
    M = tr[:, None, None] * torch.eye(3, dtype=C.dtype, device=C.device) - C
    for _ in range(4):
        M = M @ M
        M = M / (torch.linalg.matrix_norm(M)[:, None, None] + 1e-20)
    v = torch.ones(xyz.shape[0], 3, dtype=xyz.dtype, device=xyz.device)
    for _ in range(8):
        v = torch.einsum("nij,nj->ni", M, v)
        v = v / torch.sqrt((v * v).sum(-1, keepdim=True) + 1e-20)
    flip = (v * xyz).sum(-1, keepdim=True) > 0
    return torch.where(flip, -v, v)


def _pair_features(p1, n1, p2, n2):
    """Darboux-frame (alpha, phi, theta, dist) per pair, with Open3D's
    swap: the source is the point whose normal makes the smaller angle
    with the connecting line."""
    d = p2 - p1
    dist = torch.sqrt((d * d).sum(-1) + 1e-20)
    dhat = d / dist[..., None]
    a1 = (n1 * dhat).sum(-1)
    a2 = (n2 * -dhat).sum(-1)
    swap = (torch.abs(a1) < torch.abs(a2))[..., None]
    u = torch.where(swap, n2, n1)
    pt_n = torch.where(swap, n1, n2)
    dvec = torch.where(swap, -dhat, dhat)
    phi = (u * dvec).sum(-1)
    v = torch.linalg.cross(dvec, u)
    v = v / torch.sqrt((v * v).sum(-1, keepdim=True) + 1e-20)
    w = torch.linalg.cross(u, v)
    alpha = (v * pt_n).sum(-1)
    theta = torch.atan2((w * pt_n).sum(-1), (u * pt_n).sum(-1))
    return alpha, phi, theta, dist


# the value range of alpha, phi and theta, each split into nbins bins
BIN_RANGES = ((-1.0, 1.0), (-1.0, 1.0), (-math.pi, math.pi))


def pair_bins(vals, lo: float, hi: float, nbins: int = 11):
    """The bin of each pair feature in [lo, hi] (int32)."""
    return ((vals - lo) / (hi - lo) * nbins).to(torch.int32).clamp(
        0, nbins - 1)


def _spfh(xyz, normals, idx, valid, nbins: int = 11):
    """Simplified point feature histograms [N, 3 * nbins]."""
    N, k = idx.shape
    p1 = xyz[:, None, :].expand(N, k, 3)
    n1 = normals[:, None, :].expand(N, k, 3)
    feats = _pair_features(p1, n1, xyz[idx], normals[idx])
    vw = valid.to(xyz.dtype)
    cnt = vw.sum(-1, keepdim=True) + 1e-12

    def hist(vals, lo, hi):
        b = pair_bins(vals, lo, hi, nbins)
        h = torch.zeros(N, nbins, dtype=xyz.dtype, device=xyz.device)
        return h.scatter_add_(1, b.long(), vw) / cnt * 100.0

    return torch.cat([hist(v, *r) for v, r in zip(feats, BIN_RANGES)],
                     dim=-1)


def fpfh_features(xyz, normals, radius: float = 0.25, max_nn: int = 100,
                  nbins: int = 11, mask=None):
    """FPFH [N, 33]: SPFH(p) + the mean over neighbours of
    SPFH(q) / dist(p, q); unnormalized, as Open3D's."""
    idx, valid, dist = _radius_knn(xyz, radius, max_nn, mask)
    spfh = _spfh(xyz, normals, idx, valid, nbins)
    inv_d = torch.where(valid, 1.0 / torch.clamp(dist, min=1e-6),
                        torch.zeros_like(dist))
    cnt = valid.to(xyz.dtype).sum(-1, keepdim=True)
    agg = torch.einsum("nk,nkc->nc", inv_d, spfh[idx])
    fpfh = spfh + agg / torch.clamp(cnt, min=1.0)
    if mask is not None:
        fpfh = fpfh * mask[:, None]
    return fpfh


def compute_fpfh(xyz, normal_radius: float = 0.10, normal_max_nn: int = 30,
                 feature_radius: float = 0.25, feature_max_nn: int = 100,
                 mask=None):
    """Normals + FPFH + L2-normalize + NaN-scrub, the reference's recipe."""
    normals = estimate_normals(xyz, normal_radius, normal_max_nn, mask)
    feat = torch.nan_to_num(fpfh_features(xyz, normals, feature_radius,
                                          feature_max_nn, mask=mask))
    return feat / (torch.linalg.norm(feat, dim=-1, keepdim=True) + 1e-6)
