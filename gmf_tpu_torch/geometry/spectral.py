"""Spectral matching: leading eigenvector of compatibility matrices.

Counterpart of ``gmf_tpu/geometry/spectral.py``. ``leading_eigenvector``
is the power iteration capped at ``num_iters`` with the reference's early
exit. The convergence test is global over every block of the batch (one
``all``), so a converged block keeps iterating while any other block is
still moving; per-block exits would be a different result. The test
costs one host sync per round on the card; in a batch sharded over a
mesh (``parallel.sharded``) it is taken over every rank's blocks, as
gmf_tpu's sharded trace takes it. ``leading_eigenvector_fixed``
runs exactly ``num_iters`` rounds with no test; the two agree at
convergence.
"""

from __future__ import annotations

import torch

from gmf_tpu_torch.parallel.collectives import batch_all


def _safe_norm(v):
    return torch.sqrt((v * v).sum(-1, keepdim=True) + 1e-24)


def leading_eigenvector(M, num_iters: int = 10, rtol: float = 1e-5,
                        atol: float = 1e-8):
    """M [..., N, N] nonnegative -> [..., N] leading eigenvector."""
    v = torch.ones(M.shape[:-1], dtype=M.dtype, device=M.device)
    # large finite sentinel: the first round always runs
    v_last = torch.full_like(v, -1e30)
    for _ in range(num_iters):
        if batch_all(bool(
                ((v - v_last).abs() <= atol + rtol * v_last.abs()).all())):
            break
        v_new = torch.matmul(M, v[..., None])[..., 0]
        v_new = v_new / (_safe_norm(v_new) + 1e-6)
        v, v_last = v_new, v
    return v


def leading_eigenvector_fixed(M, num_iters: int = 10):
    """M [..., N, N] nonnegative -> [..., N]: ``num_iters`` power
    iterations from the all-ones vector, no convergence test (and so no
    host sync)."""
    v = torch.ones(M.shape[:-1], dtype=M.dtype, device=M.device)
    for _ in range(num_iters):
        v = torch.matmul(M, v[..., None])[..., 0]
        v = v / (_safe_norm(v) + 1e-6)
    return v
