"""Ring (sequence-parallel) compat-modulated attention over the mesh.

Counterpart of ``gmf_tpu/parallel/ring_attention.py``: for megapairs
(``num_node='all'``) whose [N, N] attention outgrows one card, the
correspondence tokens are split over the mesh's 'data' axis and the K, V,
keypoint and mask blocks travel around the ring while each rank
accumulates online-softmax statistics for its own queries, compat
rebuilt per block from the keypoints.

Every rank passes the full [N, D] inputs and gets the full [N, D] output:
each keeps its query rows, runs the ring, and the rows are all-gathered
(``parallel/collectives.py``). The blocks are plain PyTorch, as gmf_tpu's
are plain ``jnp``: f32, TF32 off, the distances in the Gram form
|a|^2 + |b|^2 - 2ab clamped at 0 as ``_block_logits`` computes them
(which loses digits where the keypoints' extent is large; the port's
kernels take per-coordinate differences instead). Autograd runs through
the ring: each hop's backward sends the gradient one hop back.
"""

from __future__ import annotations

import torch

from gmf_tpu_torch.parallel.collectives import gather_rows, hop, shard_rows
from gmf_tpu_torch.parallel.mesh import Mesh

NEG_INF = -1e9


def _sq_dist(a, b):
    """|a_i - b_j| in the Gram form, clamped at 0 before the root."""
    return torch.sqrt(torch.clamp(
        (a * a).sum(1)[:, None] + (b * b).sum(1)[None, :] - 2.0 * (a @ b.T),
        min=0.0))


def _block_logits(q, k, sq, sk, tq, tk, mask_k, sigma_sq, scale):
    """compat * q k^T * scale for one query block against one key block,
    masked keys at -1e9 (gmf_tpu/parallel/ring_attention.py:24-37)."""
    qk = (q @ k.T) * scale
    compat = torch.clamp(1.0 - (_sq_dist(sq, sk) - _sq_dist(tq, tk)) ** 2
                         / sigma_sq, min=0.0)
    s = compat * qk
    return torch.where(mask_k[None, :] > 0, s, torch.full_like(s, NEG_INF))


def ring_compat_attention(q, k, v, src_keypts, tgt_keypts, mask, mesh: Mesh,
                          axis: str = "data", sigma_d: float = 0.10):
    """Sequence-parallel compat attention.

    q, k, v [N, D] f32 and src_keypts, tgt_keypts [N, 3], mask [N], the
    same on every rank of ``axis``, N divisible by its size. Returns
    [N, D] on every rank, equal to the single-device attention.
    """
    if torch.is_tensor(q) and q.is_cuda:
        assert not torch.backends.cuda.matmul.allow_tf32
    n = mesh.shape[axis]
    if q.shape[0] % n:
        raise ValueError(f"N={q.shape[0]} does not divide over a ring of "
                         f"{n}")
    sigma_sq = float(sigma_d) ** 2
    scale = 1.0 / (q.shape[-1] ** 0.5)
    qi = shard_rows(q, mesh, axis)
    kc, vc = shard_rows(k, mesh, axis), shard_rows(v, mesh, axis)
    with torch.no_grad():
        si, ti = (shard_rows(x.detach(), mesh, axis)
                  for x in (src_keypts, tgt_keypts))
        mc = shard_rows(mask.detach(), mesh, axis)
        sc, tc = si, ti
    m_i = torch.full((qi.shape[0], 1), -float("inf"), dtype=qi.dtype,
                     device=qi.device)
    l_i = torch.zeros_like(m_i)
    acc = torch.zeros_like(qi)
    for step in range(n):
        s_blk = _block_logits(qi, kc, si, sc, ti, tc, mc, sigma_sq, scale)
        # the running maximum only steadies the exponentials: the softmax
        # does not depend on it, so it carries no gradient
        m_next = torch.maximum(m_i, s_blk.detach().amax(1, keepdim=True))
        alpha = torch.exp(m_i - m_next)
        p = torch.exp(s_blk - m_next)
        l_i = alpha * l_i + p.sum(1, keepdim=True)
        acc = acc * alpha + p @ vc
        m_i = m_next
        if step + 1 < n:  # pass the K/V/keypoint blocks one hop on
            kc, vc = hop(kc, mesh, axis), hop(vc, mesh, axis)
            with torch.no_grad():
                sc, tc, mc = (hop(x, mesh, axis) for x in (sc, tc, mc))
    return gather_rows(acc / torch.clamp(l_i, min=1e-30), mesh, axis)
