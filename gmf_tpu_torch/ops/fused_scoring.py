"""Seed-hypothesis inlier counts: CUDA kernel and its plain version.

Counterpart of ``gmf_tpu/ops/fused_scoring.py::seed_hypothesis_counts``,
batched over pairs:

    count[s] = #{ n : |R_s src_n + t_s - tgt_n|^2 < thr^2, mask_n > 0 }

The kernel uses the direct residual; the TPU's 17-wide bilinear form only
served its matrix unit. Counts are integers. ``seed_hypothesis_counts``
launches ``csrc/seed_hypothesis_counts.cu`` on CUDA tensors and uses
``seed_hypothesis_counts_plain`` only for CPU tensors.
"""

from __future__ import annotations

import torch

from gmf_tpu_torch.ops import _build

KERNEL = "seed_hypothesis_counts"


def seed_hypothesis_counts_plain(trans, src_keypts, tgt_keypts,
                                 threshold: float, mask=None):
    """Dense version over the [B, S, N] residuals -> [B, S] int32."""
    R = trans[..., :3, :3].float()
    t = trans[..., :3, 3].float()
    pred = torch.matmul(src_keypts.float()[:, None], R.transpose(-1, -2))
    resid = pred + t[:, :, None, :] - tgt_keypts.float()[:, None]
    ok = (resid * resid).sum(-1) < float(threshold) ** 2
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
    tr = trans.float().contiguous()
    src = src_keypts.float().contiguous()
    tgt = tgt_keypts.float().contiguous()
    m = (torch.ones(B, N, device=tr.device) if mask is None
         else mask.float().contiguous())
    counts = torch.empty(B, S, dtype=torch.int32, device=tr.device)
    if counts.numel() == 0:
        return counts  # nothing to launch
    code = _build.load().gmf_seed_hypothesis_counts(
        tr.data_ptr(), src.data_ptr(), tgt.data_ptr(), m.data_ptr(),
        counts.data_ptr(), B, S, N, float(threshold) ** 2,
        _build.stream_of(tr))
    _build.check(code, KERNEL)
    return counts
