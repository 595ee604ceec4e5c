"""The port's kernel modules vs gmf_tpu's Pallas kernels.

On the CPU each port wrapper runs its plain version; the JAX kernels run
in interpret mode, as gmf_tpu's own tests run them. The CUDA kernels
are held against these plain versions on the card by
tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gmf_tpu.ops import fused_attention as jattn
from gmf_tpu.ops import fused_nms as jnms
from gmf_tpu.ops import fused_scoring as jscore
from gmf_tpu.ops import fused_topk as jtopk
from gmf_tpu_torch.ops.fused_attention import compat_flash_attention
from gmf_tpu_torch.ops.fused_nms import (nms_local_max, nms_local_max_plain,
                                         pick_seeds_nms_fused)
from gmf_tpu_torch.ops.fused_scoring import seed_hypothesis_counts
from gmf_tpu_torch.ops.fused_topk import seed_knn_topk

torch.set_num_threads(1)


def _t(x):
    return torch.tensor(np.asarray(x))


def _attention_problem(rng, B=2, N=200, D=32, extent=2.5):
    q, k, v = (rng.randn(B, N, D).astype(np.float32) for _ in range(3))
    src = (rng.rand(B, N, 3) * extent).astype(np.float32)
    tgt = (src + 0.02 * rng.randn(B, N, 3)).astype(np.float32)
    tgt[:, ::3] = (rng.rand(B, (N + 2) // 3, 3) * extent).astype(np.float32)
    mask = np.ones((B, N), np.float32)
    mask[0, 150:] = 0.0
    mask[1, rng.rand(N) < 0.2] = 0.0
    return q, k, v, src, tgt, mask


def test_attention_matches_pallas_interpret(rng):
    """f32, with a mask and N=200 (not a multiple of the 64/128 blocks).
    1e-4 abs: the Pallas kernel forms distances with the norm identity,
    the port with per-coordinate differences; at 2-3 m extents the two
    differ by ~1e-6 in compat."""
    q, k, v, src, tgt, mask = _attention_problem(rng)
    got = compat_flash_attention(_t(q), _t(k), _t(v), _t(src), _t(tgt),
                                 mask=_t(mask), sigma_d=0.10)
    for b in range(q.shape[0]):
        ref = jattn.compat_flash_attention(
            jnp.asarray(q[b]), jnp.asarray(k[b]), jnp.asarray(v[b]),
            jnp.asarray(src[b]), jnp.asarray(tgt[b]),
            mask=jnp.asarray(mask[b]), sigma_d=0.10, interpret=True)
        np.testing.assert_allclose(got[b].numpy(), np.asarray(ref), atol=1e-4)


def test_nms_local_max_matches_pallas_interpret(rng):
    B, N = 2, 300
    pts = (rng.rand(B, N, 3) * 2).astype(np.float32)
    scores = rng.rand(B, N).astype(np.float32)
    scores[0, :20] = scores[0, 20:40]  # equal scores never suppress
    got = nms_local_max(_t(pts), _t(scores), 0.2)
    for b in range(B):
        ref = jnms.nms_local_max(jnp.asarray(pts[b]), jnp.asarray(scores[b]),
                                 radius=0.2, block_q=128, block_k=128,
                                 interpret=True)
        np.testing.assert_array_equal(got[b].numpy(), np.asarray(ref))


def test_pick_seeds_signed_zero_ranking(rng):
    """Negative and positive scores: non-maxima rank as +0.0 or -0.0, and
    with more seeds than local maxima those ties pick seeds; the port must
    rank as lax.top_k does (+0 before -0, then smaller index)."""
    B, N = 2, 128
    pts = rng.rand(B, N, 3).astype(np.float32)
    scores = rng.randn(B, N).astype(np.float32)
    mask = np.ones((B, N), np.float32)
    mask[1, 100:] = 0.0
    got = pick_seeds_nms_fused(_t(pts), _t(scores), 0.3, 90, mask=_t(mask))
    ref = jnms.pick_seeds_nms_fused(jnp.asarray(pts), jnp.asarray(scores),
                                    0.3, 90, mask=jnp.asarray(mask),
                                    interpret=True)
    ranked = scores * nms_local_max_plain(_t(pts), _t(scores), 0.3).numpy()
    assert (ranked == 0).sum() > 20 and np.signbit(ranked[ranked == 0]).any()
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _unit_rows(rng, n, c):
    f = rng.randn(n, c).astype(np.float32)
    return f / np.linalg.norm(f, axis=-1, keepdims=True)


@pytest.mark.parametrize("case", ["plain", "ties", "exhausted"])
def test_seed_knn_topk_matches_pallas_interpret(rng, case):
    B, S, N, C, k = 2, 24, 200, 32, 11
    feats = np.stack([_unit_rows(rng, N, C) for _ in range(B)])
    mask = np.ones((B, N), np.float32)
    mask[1, 170:] = 0.0
    if case == "ties":
        # duplicated rows tie exactly; rows orthogonal to every seed score
        # +0 or -0, which the kernel's == treats as one value
        feats[:, 100:140] = feats[:, 0:40]
        feats[0, 150:, : C // 2] = 0.0
    seeds = feats[:, :S].copy()
    if case == "ties":
        seeds[0, :, C // 2:] = 0.0
    if case == "exhausted":
        mask[0, 8:] = 0.0  # 8 valid keys < k: rows fill by index
    got, _ = seed_knn_topk(_t(seeds), _t(feats), k, mask=_t(mask))
    for b in range(B):
        ref, _ = jtopk.seed_knn_topk(jnp.asarray(seeds[b]),
                                     jnp.asarray(feats[b]), k,
                                     mask=jnp.asarray(mask[b]),
                                     interpret=True)
        np.testing.assert_array_equal(got[b].numpy(), np.asarray(ref))


def _scoring_problem(rng, B=2, S=40, N=300, thr=0.10):
    src = (rng.rand(B, N, 3) * 3).astype(np.float32)
    T = np.tile(np.eye(4, dtype=np.float32), (B, S, 1, 1))
    for b in range(B):
        for s in range(S):
            ang = 0.05 * rng.randn(3)
            c, sn = np.cos(ang[2]), np.sin(ang[2])
            T[b, s, :3, :3] = np.array([[c, -sn, 0], [sn, c, 0], [0, 0, 1]])
            T[b, s, :3, 3] = 0.05 * rng.randn(3)
    tgt = (src + 0.08 * rng.randn(B, N, 3)).astype(np.float32)
    mask = np.ones((B, N), np.float32)
    mask[1, 250:] = 0.0
    # drop points within 1e-4 of the threshold under any seed: only the
    # float knife-edge may differ between the residual and bilinear forms
    res = (np.einsum("bsij,bnj->bsni", T[..., :3, :3].astype(np.float64),
                     src) + T[:, :, None, :3, 3] - tgt[:, None])
    d = np.linalg.norm(res, axis=-1)
    edge = (np.abs(d - thr) < 1e-4).any(1)
    mask[edge] = 0.0
    return T, src, tgt, mask


def test_seed_hypothesis_counts_matches_pallas_interpret(rng):
    T, src, tgt, mask = _scoring_problem(rng)
    got = seed_hypothesis_counts(_t(T), _t(src), _t(tgt), 0.10,
                                 mask=_t(mask))
    assert got.dtype == torch.int32
    for b in range(T.shape[0]):
        ref = jscore.seed_hypothesis_counts(
            jnp.asarray(T[b]), jnp.asarray(src[b]), jnp.asarray(tgt[b]),
            0.10, mask=jnp.asarray(mask[b]), interpret=True)
        np.testing.assert_array_equal(got[b].numpy(),
                                      np.asarray(ref).astype(np.int32))
    assert 0 < int(got.max()) < int(mask.sum(-1).max())
