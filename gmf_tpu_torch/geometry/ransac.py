"""Batched RANSAC on correspondences, in PyTorch on the model's device.

Counterpart of ``gmf_tpu/geometry/ransac.py``, which replaces the
reference's Open3D ``registration_ransac_based_on_correspondence``
(evaluation/test_3DMatch.py:75-93, 5000 iterations): every hypothesis is
drawn and solved at once (a minimal 3-point Horn-quaternion Kabsch),
scored by inlier count in chunks of hypotheses so that no [hypotheses, N]
distance matrix is ever held, and the best one is refit on its inliers.

The draw is its own function (``ransac_sample_indices``, from a
``torch.Generator``) so that the rest (``ransac_from_indices``) can run on
any draw, the JAX package's among them.
"""

from __future__ import annotations

from typing import Optional

import torch

from gmf_tpu_torch.geometry.kabsch import kabsch_quat, rigid_transform_3d


def _norm3(x):
    """Euclidean norm over the last axis as sqrt(sum(x * x)), the form
    ``jnp.linalg.norm`` computes (``torch.linalg.norm`` over an axis of 3
    takes a CPU path ~20x slower than this)."""
    return torch.sqrt((x * x).sum(-1))


def ransac_sample_indices(generator: torch.Generator, num_points: int,
                          num_iters: int = 5000, sample_size: int = 3,
                          chunk: int = 1024,
                          mask: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """[total, sample_size] int64 point indices, ``total`` = ``num_iters``
    rounded up to ``chunk``, on the generator's device. With ``mask``,
    drawn only among the valid rows (valid rows first in a stable order,
    then uniform positions among the first n_valid), as the reference."""
    total = -(-num_iters // chunk) * chunk
    dev = generator.device
    if mask is None:
        return torch.randint(0, num_points, (total, sample_size),
                             generator=generator, device=dev)
    mask_b = mask.to(dev).bool()
    order = torch.argsort((~mask_b).to(torch.int8), stable=True)
    n_val = mask_b.sum().clamp(min=1)
    u = torch.rand((total, sample_size), generator=generator, device=dev)
    pos = torch.minimum((u * n_val).long(), n_val - 1)
    return order[pos]


def ransac_from_indices(src, tgt, idx, inlier_threshold: float,
                        chunk: int = 1024, mask=None):
    """RANSAC over the hypotheses ``idx`` [total, sample_size] draws.

    src, tgt: [N, 3] corresponding points; mask: optional [N] validity.
    Returns (trans [4, 4], inlier mask [N] bool, fitness scalar), on the
    points' device and without a host sync."""
    sample_size = idx.shape[1]
    idx = idx.to(src.device)
    valid = (torch.ones(src.shape[0], dtype=src.dtype, device=src.device)
             if mask is None else mask.to(src.dtype))
    n_valid = valid.sum()
    if mask is not None:
        # zero padded rows: NaN padding must not reach the refit or scores
        src = torch.where(valid[:, None] > 0, src, torch.zeros_like(src))
        tgt = torch.where(valid[:, None] > 0, tgt, torch.zeros_like(tgt))

    hyps = kabsch_quat(src[idx], tgt[idx])  # [total, 4, 4]
    scores = []
    for h in hyps.split(chunk):
        warped = (torch.einsum("cij,nj->cni", h[:, :3, :3], src)
                  + h[:, None, :3, 3])
        d = _norm3(warped - tgt[None])
        scores.append(((d < inlier_threshold).to(src.dtype)
                       * valid[None]).sum(-1))
    T_best = hyps[torch.argmax(torch.cat(scores))]

    # refit on the best hypothesis's inliers (Open3D's own refinement)
    warped = src @ T_best[:3, :3].T + T_best[:3, 3]
    d = _norm3(warped - tgt)
    inlier = (d < inlier_threshold) & (valid > 0)
    w = inlier.to(src.dtype)
    T = torch.where(w.sum() >= sample_size,
                    rigid_transform_3d(src[None], tgt[None], w[None])[0],
                    T_best)
    return T, inlier, w.sum() / (n_valid + 1e-6)


def ransac_registration(generator: torch.Generator, src, tgt,
                        inlier_threshold: float, num_iters: int = 5000,
                        sample_size: int = 3, chunk: int = 1024, mask=None):
    """Draw from ``generator`` and run ``ransac_from_indices``."""
    idx = ransac_sample_indices(generator, src.shape[0], num_iters,
                                sample_size, chunk, mask)
    return ransac_from_indices(src, tgt, idx, inlier_threshold, chunk, mask)
