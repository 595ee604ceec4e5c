"""Seed-hypothesis inlier counts: CUDA kernel and its plain version.

Counterpart of ``gmf_tpu/ops/fused_scoring.py::seed_hypothesis_counts``,
batched over pairs:

    count[s] = #{ n : |R_s src_n + t_s - tgt_n|^2 < thr^2, mask_n > 0 }

The kernel uses the direct residual; the TPU's 17-wide bilinear form only
served its matrix unit. The residual is formed with rounded f32
operations in one fixed order, per coordinate ((R0 x + R1 y) + R2 z) + t
- u, then (px^2 + py^2) + pz^2, by the kernel and by the plain version
alike, so the two agree on every count. Counts are integers.
``seed_hypothesis_counts`` launches ``csrc/seed_hypothesis_counts.cu`` on
CUDA tensors and uses ``seed_hypothesis_counts_plain`` only for CPU
tensors.
"""

from __future__ import annotations

import torch

from gmf_tpu_torch.ops import _build

KERNEL = "seed_hypothesis_counts"


def seed_residuals_sq_plain(trans, src_keypts, tgt_keypts):
    """|R_s src_n + t_s - tgt_n|^2 [B, S, N] f32, elementwise in the
    kernel's order: one rounded f32 operation at a time, no matrix
    product, no fused multiply-add."""
    T = trans.float()
    src = src_keypts.float()[:, None]  # [B, 1, N, 3]
    tgt = tgt_keypts.float()[:, None]
    x, y, z = src[..., 0], src[..., 1], src[..., 2]

    def coord(r):
        R = T[:, :, r, :, None]  # [B, S, 4, 1]: R_r0, R_r1, R_r2, t_r
        return ((R[:, :, 0] * x + R[:, :, 1] * y) + R[:, :, 2] * z
                + R[:, :, 3]) - tgt[..., r]

    px, py, pz = coord(0), coord(1), coord(2)
    return (px * px + py * py) + pz * pz


def seed_hypothesis_counts_plain(trans, src_keypts, tgt_keypts,
                                 threshold: float, mask=None):
    """Dense version over the [B, S, N] residuals -> [B, S] int32."""
    thr_sq = torch.tensor(float(threshold) ** 2, dtype=torch.float32)
    ok = seed_residuals_sq_plain(trans, src_keypts, tgt_keypts) < thr_sq
    if mask is not None:
        ok = ok & (mask[:, None, :] > 0)
    return ok.sum(-1).int()


def seed_hypothesis_counts(trans, src_keypts, tgt_keypts, threshold: float,
                           mask=None):
    """trans [B, S, 4, 4], keypoints [B, N, 3], mask optional [B, N]
    -> inlier counts [B, S] int32."""
    if trans.device.type == "cpu":
        return seed_hypothesis_counts_plain(trans, src_keypts, tgt_keypts,
                                            threshold, mask)
    if trans.device.type != "cuda":
        raise ValueError(f"{KERNEL}: unsupported device {trans.device}")
    B, S = trans.shape[:2]
    N = src_keypts.shape[1]
    if trans.shape != (B, S, 4, 4) or src_keypts.shape != (B, N, 3) \
            or tgt_keypts.shape != (B, N, 3):
        raise ValueError(f"{KERNEL}: expected [B, S, 4, 4] and [B, N, 3]")
    if mask is not None and mask.shape != (B, N):
        raise ValueError(f"{KERNEL}: mask must be [B, N]")
    tr = trans.float().contiguous()
    if tr.data_ptr() % 16:  # the kernel reads each seed's rows as float4
        tr = tr.clone()
    src = src_keypts.float().contiguous()
    tgt = tgt_keypts.float().contiguous()
    m = None if mask is None else mask.float().contiguous()
    counts = torch.empty(B, S, dtype=torch.int32, device=tr.device)
    if counts.numel() == 0 or N == 0:
        return counts.zero_()  # nothing to launch: no point counts
    code = _build.load().gmf_seed_hypothesis_counts(
        tr.data_ptr(), src.data_ptr(), tgt.data_ptr(),
        None if m is None else m.data_ptr(), counts.data_ptr(), B, S, N,
        float(threshold) ** 2, _build.stream_of(tr))
    _build.check(code, KERNEL)
    return counts
