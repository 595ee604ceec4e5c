"""Seed kNN in feature space: CUDA top-k kernel and its plain version.

Counterpart of ``gmf_tpu/ops/fused_topk.py::seed_knn_topk``, batched over
pairs. Ranks keys by the inner product with each seed, accumulated in f32
(descending, ties to the smaller index, masked keys at -inf and still
selectable in ascending index order), as ``jax.lax.top_k`` over ``-dist``
does. ``feats`` takes ``seed_feats``' dtype first, as in the reference
(fused_topk.py:105); bf16 products are exact in f32, f32 ones are full
f32. ``seed_knn_topk`` launches ``csrc/seed_knn_topk.cu`` on CUDA tensors
(its bf16 or f32 instance, by dtype) and uses ``seed_knn_topk_plain`` only
for CPU tensors.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from gmf_tpu_torch.ops import _build

# the launch count of each instance, by the features' dtype
KERNELS = {torch.bfloat16: "seed_knn_topk_bf16",
           torch.float32: "seed_knn_topk_f32"}
MAX_K = 128  # the reference's top-k width (fused_topk.py:38)
DEPTH = 128  # the kernel's feature depth; shallower features are padded


def seed_knn_topk_plain(seed_feats, feats, k: int, mask=None):
    """Matmul in f32, then a stable descending sort; the first k columns."""
    sc = torch.matmul(seed_feats.float(),
                      feats.to(seed_feats.dtype).float().transpose(-1, -2))
    if mask is not None:
        sc = torch.where(mask[:, None, :] > 0, sc,
                         torch.full_like(sc, float("-inf")))
    order = torch.sort(sc, dim=-1, descending=True, stable=True)
    return order.indices[..., :k].int(), order.values[..., :k]


def seed_knn_topk(seed_feats, feats, k: int, mask=None):
    """Top-k neighbours of each seed row.

    seed_feats [B, S, C] bf16 or f32, feats [B, N, C], mask optional
    [B, N]; 1 <= k <= min(N, 128). Returns (idx [B, S, k] int32,
    score [B, S, k] f32), best first.
    """
    N = feats.shape[1]
    if k > N:
        raise ValueError(f"k={k} > N={N}")
    if k > MAX_K:
        raise ValueError(f"k={k} exceeds the kernel's top-k width {MAX_K}")
    if feats.device.type == "cpu":
        return seed_knn_topk_plain(seed_feats, feats, k, mask)
    if feats.device.type != "cuda":
        raise ValueError(f"seed_knn_topk: unsupported device {feats.device}")
    B, S, C = seed_feats.shape
    if feats.shape != (B, N, C):
        raise ValueError("seed_knn_topk: feats must be [B, N, C]")
    if seed_feats.dtype not in KERNELS:
        raise TypeError("seed_knn_topk: features must be f32 or bf16, got "
                        f"{seed_feats.dtype}")
    if C > DEPTH:
        raise ValueError(f"seed_knn_topk: depth C={C} above {DEPTH}")
    name = KERNELS[seed_feats.dtype]
    sf, f = seed_feats, feats.to(seed_feats.dtype)
    if C < DEPTH:  # zero columns add nothing to a product
        sf, f = F.pad(sf, (0, DEPTH - C)), F.pad(f, (0, DEPTH - C))
    sf, f = sf.contiguous(), f.contiguous()
    m = (torch.ones(B, N, device=f.device) if mask is None
         else mask.float().contiguous())
    idx = torch.empty(B, S, k, dtype=torch.int32, device=f.device)
    val = torch.empty(B, S, k, device=f.device)
    if idx.numel() == 0:
        return idx, val  # nothing to launch
    code = _build.load().gmf_seed_knn_topk(
        sf.data_ptr(), f.data_ptr(), m.data_ptr(), idx.data_ptr(),
        val.data_ptr(), B, S, N, DEPTH, k,
        int(seed_feats.dtype == torch.bfloat16), _build.stream_of(f))
    _build.check(code, name)
    return idx, val
