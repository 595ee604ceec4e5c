"""Score-NMS seed selection, dense form.

Counterpart of ``gmf_tpu/geometry/nms.py::pick_seeds_nms``: a point is a
local max if no strictly higher-scoring point lies within the radius;
seeds are the top ``max_num`` of ``score * is_local_max``. It is the
plain version of the NMS stage that ``ops/fused_nms.py`` streams.
"""

from __future__ import annotations

import torch


def topk_total_order(x, k: int):
    """Indices of the ``k`` largest entries of f32 ``x`` along the last
    axis, in the order ``jax.lax.top_k`` gives them.

    top_k orders floats totally (+0.0 ranks above -0.0) and breaks equal
    keys toward the smaller index. ``score * is_local_max`` is +-0.0 for
    every non-maximum, so with untrained weights those ties decide which
    points become seeds. The float bits map onto an integer key with the
    same total order, and a stable descending sort keeps index order on
    equal keys.
    """
    bits = x.float().contiguous().view(torch.int32)
    key = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    return torch.sort(key, dim=-1, descending=True, stable=True).indices[
        ..., :k]


def pick_seeds_nms(dists, scores, radius: float, max_num: int, mask=None):
    """dists [B, N, N], scores [B, N] -> [B, max_num] int64 seed indices,
    best first. Masked entries can never be seeds."""
    relation = ((scores[..., :, None] >= scores[..., None, :])
                | (dists >= radius))
    is_local_max = relation.all(-1).to(scores.dtype)
    ranked = scores * is_local_max
    if mask is not None:
        ranked = torch.where(mask > 0, ranked,
                             torch.full_like(ranked, float("-inf")))
    return topk_total_order(ranked, max_num)
