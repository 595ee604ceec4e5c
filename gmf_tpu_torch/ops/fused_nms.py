"""Score-NMS local maxima: streaming CUDA kernel and its plain version.

Counterpart of ``gmf_tpu/ops/fused_nms.py``, batched over pairs:

    is_local_max[i] = NOT OR_j ( |s_i - s_j|^2 < R^2  AND  score_j > score_i )

Every row of the bucket takes part, masked ones included, as in the JAX
package; the mask only keeps masked rows from becoming seeds.
``nms_local_max`` launches ``csrc/nms_local_max.cu`` on CUDA tensors and
uses ``nms_local_max_plain`` only for CPU tensors.
"""

from __future__ import annotations

import torch

from gmf_tpu_torch.geometry.nms import topk_total_order
from gmf_tpu_torch.ops import _build

KERNEL = "nms_local_max"


def nms_local_max_plain(src_keypts, scores, radius: float):
    """Dense version over the [B, N, N] relation matrix.
    [B, N, 3], [B, N] -> [B, N] f32 (1 = local max)."""
    s = src_keypts.float()
    sc = scores.float()
    diff = [s[:, :, None, c] - s[:, None, :, c] for c in range(3)]
    d2 = diff[0] * diff[0] + diff[1] * diff[1] + diff[2] * diff[2]
    suppressed = ((d2 < float(radius) ** 2)
                  & (sc[:, None, :] > sc[:, :, None])).any(-1)
    return (~suppressed).float()


def nms_local_max(src_keypts, scores, radius: float):
    """is_local_max [B, N] f32 for keypoints [B, N, 3] and scores [B, N]."""
    if src_keypts.device.type == "cpu":
        return nms_local_max_plain(src_keypts, scores, radius)
    if src_keypts.device.type != "cuda":
        raise ValueError(f"{KERNEL}: unsupported device {src_keypts.device}")
    B, N, _ = src_keypts.shape
    if src_keypts.shape != (B, N, 3) or scores.shape != (B, N):
        raise ValueError(f"{KERNEL}: expected [B, N, 3] and [B, N]")
    kp = src_keypts.float().contiguous()
    sc = scores.float().contiguous()
    out = torch.empty(B, N, device=kp.device)
    if out.numel() == 0:
        return out  # nothing to launch
    code = _build.load().gmf_nms_local_max(
        kp.data_ptr(), sc.data_ptr(), out.data_ptr(), B, N,
        float(radius) ** 2, _build.stream_of(kp))
    _build.check(code, KERNEL)
    return out


def pick_seeds_nms_fused(src_keypts, scores, radius: float, max_num: int,
                         mask=None):
    """Seeds by score-NMS without a [B, N, N] matrix on the card.
    src_keypts [B, N, 3], scores [B, N] -> [B, max_num] int64, best first,
    ranked in ``jax.lax.top_k``'s total order (geometry.nms)."""
    ranked = scores.float() * nms_local_max(src_keypts, scores, radius)
    if mask is not None:
        ranked = torch.where(mask > 0, ranked,
                             torch.full_like(ranked, float("-inf")))
    return topk_total_order(ranked, max_num)
