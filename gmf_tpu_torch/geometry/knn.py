"""k-nearest neighbours in feature space.

Counterpart of ``gmf_tpu/geometry/knn.py``: pairwise distances as one
matmul plus rank-1 corrections, ``knn`` with ``lax.top_k``'s order
(``geometry/nms.py::topk_total_order``), and 1-NN matching chunked over
query rows, so that the distances held at once are ``chunk x N1``, the
bound of the reference's row chunking.
"""

from __future__ import annotations

import math

import torch

from gmf_tpu_torch.geometry.nms import topk_total_order


def pdist(A, B, dist_type: str = "SquareL2"):
    """Pairwise distances between rows of A [..., N, D] and B [..., M, D]:
    "SquareL2" or "L2" (sqrt(max(d2, 0) + 1e-7))."""
    d2 = ((A * A).sum(-1)[..., :, None]
          - 2.0 * torch.matmul(A, B.transpose(-1, -2))
          + (B * B).sum(-1)[..., None, :])
    if dist_type == "SquareL2":
        return d2
    if dist_type == "L2":
        return torch.sqrt(torch.clamp(d2, min=0.0) + 1e-7)
    raise NotImplementedError(f"dist_type {dist_type!r}")


def knn(x, k: int, ignore_self: bool = False, normalized: bool = True,
        mask=None):
    """Indices [B, N, k] (int64) of the k nearest rows of each row of x
    [B, N, C] within x, nearest first, ties to the smaller index.

    ``normalized``: rows are unit vectors, d = 2 - 2 <x_i, x_j>; else the
    squared distance. ``ignore_self`` takes k + 1 and drops the first (the
    row itself). ``mask`` [B, N]: rows at 0 are never neighbours."""
    inner = 2.0 * torch.matmul(x, x.transpose(-1, -2))
    if normalized:
        dist = 2.0 - inner
    else:
        xx = (x * x).sum(-1, keepdim=True)
        dist = xx - inner + xx.transpose(-1, -2)
    if mask is not None:
        dist = dist.masked_fill(mask[..., None, :] <= 0, math.inf)
    idx = topk_total_order(-dist, k + 1 if ignore_self else k)
    return idx[..., 1:] if ignore_self else idx


def nearest_neighbor(F0, F1, chunk: int = 2048):
    """1-NN of each row of F0 [N0, D] among the rows of F1 [N1, D]:
    (idx [N0] int32, squared distance [N0]). ``chunk`` rows of F0 at a
    time; the first of equal distances wins, as ``jnp.argmin``."""
    b1 = (F1 * F1).sum(-1)
    idx, d2 = [], []
    for start in range(0, F0.shape[0], chunk):
        fc = F0[start:start + chunk]
        d = ((fc * fc).sum(-1)[:, None] - 2.0 * torch.matmul(fc, F1.T)
             + b1[None, :])
        best = d.min(-1)
        idx.append(best.indices.int())
        d2.append(best.values)
    if not idx:
        return (torch.zeros(0, dtype=torch.int32, device=F0.device),
                F0.new_zeros(0))
    return torch.cat(idx), torch.cat(d2)


def mutual_nearest_mask(F0, F1, chunk: int = 2048):
    """(mask [N0] bool: the rows of F0 whose 1-NN in F1 has them as its
    own 1-NN, idx01 [N0] int32)."""
    idx01, _ = nearest_neighbor(F0, F1, chunk=chunk)
    idx10, _ = nearest_neighbor(F1, F0, chunk=chunk)
    back = idx10[idx01.long()]
    return back == torch.arange(F0.shape[0], dtype=torch.int32,
                                device=F0.device), idx01
