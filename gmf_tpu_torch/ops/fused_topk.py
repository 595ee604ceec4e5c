"""Seed kNN in feature space: CUDA top-k kernel and its plain version.

Counterpart of ``gmf_tpu/ops/fused_topk.py::seed_knn_topk``, batched over
pairs. Ranks keys by the f32 inner product with each seed (descending,
ties to the smaller index, masked keys at -inf and still selectable in
ascending index order), as ``jax.lax.top_k`` over ``-dist`` does.
``seed_knn_topk`` launches ``csrc/seed_knn_topk.cu`` on CUDA tensors and
uses ``seed_knn_topk_plain`` only for CPU tensors.
"""

from __future__ import annotations

import torch

from gmf_tpu_torch.ops import _build

KERNEL = "seed_knn_topk"


def seed_knn_topk_plain(seed_feats, feats, k: int, mask=None):
    """Matmul, then a stable descending sort; the first k columns."""
    sc = torch.matmul(seed_feats.float(), feats.float().transpose(-1, -2))
    if mask is not None:
        sc = torch.where(mask[:, None, :] > 0, sc,
                         torch.full_like(sc, float("-inf")))
    order = torch.sort(sc, dim=-1, descending=True, stable=True)
    return order.indices[..., :k].int(), order.values[..., :k]


def seed_knn_topk(seed_feats, feats, k: int, mask=None):
    """Top-k neighbours of each seed row.

    seed_feats [B, S, C], feats [B, N, C], mask optional [B, N].
    Returns (idx [B, S, k] int32, score [B, S, k] f32), best first.
    """
    N = feats.shape[1]
    if k > N:
        raise ValueError(f"k={k} > N={N}")
    if feats.device.type == "cpu":
        return seed_knn_topk_plain(seed_feats, feats, k, mask)
    if feats.device.type != "cuda":
        raise ValueError(f"{KERNEL}: unsupported device {feats.device}")
    B, S, C = seed_feats.shape
    if feats.shape != (B, N, C):
        raise ValueError(f"{KERNEL}: feats must be [B, N, C]")
    sf = seed_feats.float().contiguous()
    f = feats.float().contiguous()
    m = (torch.ones(B, N, device=f.device) if mask is None
         else mask.float().contiguous())
    idx = torch.empty(B, S, k, dtype=torch.int32, device=f.device)
    val = torch.empty(B, S, k, device=f.device)
    if idx.numel() == 0:
        return idx, val  # nothing to launch
    code = _build.load().gmf_seed_knn_topk(
        sf.data_ptr(), f.data_ptr(), m.data_ptr(), idx.data_ptr(),
        val.data_ptr(), B, S, N, C, k, _build.stream_of(f))
    _build.check(code, KERNEL)
    return idx, val
