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
from gmf_tpu.ops import fused_seed_solver as jsolver
from gmf_tpu.ops import fused_topk as jtopk
from gmf_tpu_torch.ops.fused_attention import (build_compat_cache,
                                               cache_row_stride,
                                               compat_flash_attention,
                                               compat_flash_attention_build)
from gmf_tpu_torch.ops.fused_nms import (nms_local_max, nms_local_max_plain,
                                         pick_seeds_nms_fused)
from gmf_tpu_torch.ops.fused_scoring import seed_hypothesis_counts
from gmf_tpu_torch.ops.fused_seed_solver import (fused_seed_transforms,
                                                 fused_seed_weights)
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


_JAX_CACHE_DTYPES = {torch.float32: jnp.float32,
                     torch.bfloat16: jnp.bfloat16, torch.int8: jnp.int8}


def _jax_cache(src, tgt, sigma_d, dtype):
    """gmf_tpu's cache of one pair in interpret mode, as float64 numpy;
    its valid part is [:N, :N] of the padded [Np, Np] array."""
    c = jattn.build_compat_cache(jnp.asarray(src), jnp.asarray(tgt),
                                 sigma_d=sigma_d,
                                 dtype=_JAX_CACHE_DTYPES[dtype],
                                 interpret=True)
    return c


def _eager_jnp_cache(src, tgt, sigma_d, dtype):
    """The formulas of gmf_tpu's ``_compat_pre_kernel`` for one pair
    through eager jnp calls: one XLA computation per operation, so nothing
    is fused and every operation rounds once."""
    s, t = jnp.asarray(src), jnp.asarray(tgt)
    ds2 = dt2 = None
    for d in range(3):
        sd = s[:, None, d] - s[None, :, d]
        td = t[:, None, d] - t[None, :, d]
        ds2 = sd * sd if ds2 is None else ds2 + sd * sd
        dt2 = td * td if dt2 is None else dt2 + td * td
    sigma_sq = float(sigma_d) ** 2
    if dtype == torch.int8:
        dd2 = jnp.maximum(ds2 + dt2 - 2.0 * jnp.sqrt(ds2 * dt2), 0.0)
        c = jnp.maximum(1.0 - dd2 / sigma_sq, 0.0)
        return np.asarray(jnp.round(c * 254.0 - 127.0).astype(jnp.int8))
    dd = jnp.sqrt(ds2) - jnp.sqrt(dt2)
    c = jnp.maximum(1.0 - dd * dd / sigma_sq, 0.0)
    return np.asarray(c.astype(_JAX_CACHE_DTYPES[dtype]).astype(jnp.float32))


def _assert_codes_close(mine, ref, share):
    """int8 codes: never more than 1 apart, and apart on at most ``share``
    of the entries."""
    gap = np.abs(mine.astype(np.int32) - ref.astype(np.int32))
    assert gap.max() <= 1, gap.max()
    assert (gap > 0).mean() <= share, (gap > 0).mean()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_build_compat_cache_matches_pallas_interpret(rng, dtype):
    """N=200 is no multiple of 64. The port rounds every operation once,
    and so equals the kernel's formula evaluated through eager jnp calls
    in every entry, for each cache type. XLA's CPU backend fuses the
    interpreted kernel's operations and rounds some of them together, and
    compat = 1 - dd^2 / sigma^2 amplifies one ulp of a 2.5 m distance
    (2.4e-7) by 2 dd / sigma^2, up to ~30: the eager evaluation is as far
    from the interpreted kernel as the port is. Measured against the
    kernel: f32 7.1e-6, so 1e-5; bf16 within one bf16 ulp beneath 1
    (2^-8); int8 one code apart on 2.4e-3 of the entries, so at most 1
    code on at most 3e-3."""
    _, _, _, src, tgt, _ = _attention_problem(rng)
    B, N, _ = src.shape
    got = build_compat_cache(_t(src), _t(tgt), 0.10, dtype)
    ld = cache_row_stride(N, dtype)
    assert got.shape == (B, N, ld) and got.dtype == dtype
    assert ld % (16 // got.element_size()) == 0 and N <= ld < N + 16
    assert (got[:, :, N:] == 0).all()
    for b in range(B):
        ref = np.asarray(_jax_cache(src[b], tgt[b], 0.10, dtype)[:N, :N]
                         .astype(jnp.float32))
        mine = got[b, :, :N].float().numpy()
        np.testing.assert_array_equal(
            mine, _eager_jnp_cache(src[b], tgt[b], 0.10, dtype))
        if dtype == torch.float32:
            np.testing.assert_allclose(mine, ref, atol=1e-5)
        elif dtype == torch.bfloat16:
            np.testing.assert_allclose(mine, ref, atol=2.0 ** -8)
            assert (mine != ref).mean() < 5e-3
        else:
            _assert_codes_close(mine, ref, 3e-3)
    assert 0.02 < (got[:, :, :N].float() > got.float().min()).float().mean()


def test_build_compat_cache_int8_kitti_extents(rng):
    """Coordinates up to 120 m with sigma_d = 1.2 (the KITTI setting).
    The one-sqrt form ds2 + dt2 - 2 sqrt(ds2 dt2) cancels terms of ~1e4 m^2
    down to ~1 m^2, so it is sensitive to the last bit of ds2 and dt2.
    The port's codes equal the formula's eager jnp evaluation in every
    entry; gmf_tpu's interpreted kernel, whose operations XLA's CPU
    backend fuses, is 1 code from both on 3.8e-2 of the entries (measured;
    at most 4.5e-2 here). The one-sqrt and two-sqrt FORMS differ there
    too: by 1 code on 8e-2 of the entries at 120 m and by up to 4 codes
    (more than 1 on 1.8e-2) at 240 m, measured with N=512 and this test's
    noise. That is a property of the reference's int8 formula, which the
    port keeps as it is."""
    B, N = 1, 256
    src = (rng.rand(B, N, 3) * 120).astype(np.float32)
    tgt = (src + 0.3 * rng.randn(B, N, 3)).astype(np.float32)
    got = build_compat_cache(_t(src), _t(tgt), 1.2, torch.int8)
    mine = got[0, :, :N].numpy()
    np.testing.assert_array_equal(
        mine, _eager_jnp_cache(src[0], tgt[0], 1.2, torch.int8))
    ref = np.asarray(_jax_cache(src[0], tgt[0], 1.2, torch.int8))[:N, :N]
    _assert_codes_close(mine, ref, 4.5e-2)
    assert (got[0, :, :N] > -127).float().mean() > 0.02
    for extent, low, high in ((120.0, 1, 2), (240.0, 2, 8)):
        s2 = _t(src * np.float32(extent / 120.0))
        t2 = s2 + _t(tgt - src)
        one = build_compat_cache(s2, t2, 1.2, torch.int8)[0, :, :N].float()
        two = build_compat_cache(s2, t2, 1.2, torch.float32)[0, :, :N]
        gap = (one - torch.round(two * 254.0 - 127.0)).abs().max().item()
        assert low <= gap <= high, (extent, gap)


def test_build_attend_matches_pallas_interpret(rng):
    """Cache equal to the port's own standalone int8 cache, and at most 1
    code from gmf_tpu's build kernel's on at most 2e-3 of the entries (XLA's
    fusion of the interpreted kernel, see
    test_build_compat_cache_matches_pallas_interpret; measured 1.5e-3).
    Out equal to the port's cached mode on that cache; within 1e-4 of
    gmf_tpu's cached kernel fed the port's codes (summation order only);
    within 1e-3 of gmf_tpu's build kernel's out, whose differing codes
    move a compat by 1/254 each (measured 2.2e-4)."""
    q, k, v, src, tgt, mask = _attention_problem(rng)
    B, N, _ = q.shape
    args = [_t(x) for x in (q, k, v, src, tgt)]
    out, cache = compat_flash_attention_build(*args, mask=_t(mask),
                                              sigma_d=0.10)
    assert cache.dtype == torch.int8
    assert torch.equal(cache, build_compat_cache(_t(src), _t(tgt), 0.10,
                                                 torch.int8))
    cached = compat_flash_attention(*args[:3], None, None, mask=_t(mask),
                                    compat=cache)
    assert torch.equal(out, cached)
    for b in range(B):
        ref_out, ref_cache = jattn.compat_flash_attention_build(
            jnp.asarray(q[b]), jnp.asarray(k[b]), jnp.asarray(v[b]),
            jnp.asarray(src[b]), jnp.asarray(tgt[b]),
            mask=jnp.asarray(mask[b]), sigma_d=0.10, interpret=True)
        ref_cache = np.asarray(ref_cache)
        _assert_codes_close(cache[b, :, :N].numpy(), ref_cache[:N, :N], 2e-3)
        np.testing.assert_allclose(out[b].numpy(), np.asarray(ref_out),
                                   atol=1e-3)
        mine = ref_cache.copy()
        mine[:N, :N] = cache[b, :, :N].numpy()
        ref_same = jattn.compat_flash_attention(
            jnp.asarray(q[b]), jnp.asarray(k[b]), jnp.asarray(v[b]), None,
            None, mask=jnp.asarray(mask[b]), compat=jnp.asarray(mine),
            interpret=True)
        np.testing.assert_allclose(out[b].numpy(), np.asarray(ref_same),
                                   atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_cached_attention_matches_pallas_interpret(rng, dtype):
    """Both sides attend on the same cache values, built by gmf_tpu's
    cache kernel ([Np, Np] there, its valid part copied into the port's
    [B, N, ld] layout), with a mask: 1e-4, f32 summation order only."""
    q, k, v, src, tgt, mask = _attention_problem(rng)
    B, N, _ = q.shape
    jcaches = [_jax_cache(src[b], tgt[b], 0.10, dtype) for b in range(B)]
    cache = torch.zeros(B, N, cache_row_stride(N, dtype), dtype=dtype)
    for b in range(B):
        cache[b, :, :N] = _t(jcaches[b][:N, :N].astype(jnp.float32)).to(dtype)
    got = compat_flash_attention(_t(q), _t(k), _t(v), None, None,
                                 mask=_t(mask), compat=cache)
    for b in range(B):
        ref = jattn.compat_flash_attention(
            jnp.asarray(q[b]), jnp.asarray(k[b]), jnp.asarray(v[b]), None,
            None, mask=jnp.asarray(mask[b]), compat=jcaches[b],
            interpret=True)
        np.testing.assert_allclose(got[b].numpy(), np.asarray(ref), atol=1e-4)


def test_cached_attention_f32_matches_streaming_and_checks_layout(rng):
    """The f32 cache holds the streaming mode's formula: 1e-5. A cache of
    another layout is refused."""
    q, k, v, src, tgt, mask = _attention_problem(rng)
    args = [_t(x) for x in (q, k, v)]
    cache = build_compat_cache(_t(src), _t(tgt), 0.10, torch.float32)
    got = compat_flash_attention(*args, None, None, mask=_t(mask),
                                 compat=cache)
    stream = compat_flash_attention(*args, _t(src), _t(tgt), mask=_t(mask),
                                    sigma_d=0.10)
    np.testing.assert_allclose(got.numpy(), stream.numpy(), atol=1e-5)
    with pytest.raises(ValueError, match="layout"):
        compat_flash_attention(*args, None, None, compat=cache[:, :, :-1])
    with pytest.raises(ValueError, match="layout"):
        compat_flash_attention(*args, None, None, compat=cache[:1])


def _seed_problem(rng, B, S, k, C, scale=3.0):
    feats = rng.randn(B, S, k, C).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=-1, keepdims=True)
    src = (rng.rand(B, S, k, 3) * scale).astype(np.float32)
    ang = 0.3
    R = np.array([[np.cos(ang), -np.sin(ang), 0],
                  [np.sin(ang), np.cos(ang), 0], [0, 0, 1]], np.float32)
    tgt = src @ R.T + np.array([0.2, -0.1, 0.4], np.float32)
    tgt += 0.02 * rng.randn(B, S, k, 3).astype(np.float32)
    out = rng.rand(B, S, k) < 0.33  # gross outliers, as in real kNN sets
    tgt = np.where(out[..., None], rng.rand(B, S, k, 3) * scale, tgt)
    return feats, src, tgt.astype(np.float32)


@pytest.mark.parametrize("S,k,C", [(13, 16, 32), (10, 40, 64)])
def test_fused_seed_solver_matches_pallas_interpret(rng, S, k, C):
    """S is no multiple of the Pallas tile of 8 seeds. Weights (~1/k) to
    1e-5; transforms with the bounds of tests/test_fused_seed_solver.py
    (rotation 5e-4, translation 5e-3: eigenvector conditioning)."""
    B = 2
    feats, src, tgt = _seed_problem(rng, B, S, k, C)
    sigma = 1.2
    got_w = fused_seed_weights(_t(feats), _t(src), _t(tgt),
                               torch.tensor([sigma]), 0.10)
    got_T = fused_seed_transforms(_t(feats), _t(src), _t(tgt), sigma, 0.10)
    assert got_w.shape == (B, S, k) and got_T.shape == (B, S, 4, 4)
    for b in range(B):
        a = [jnp.asarray(x[b]) for x in (feats, src, tgt)]
        ref_w = jsolver.fused_seed_weights(*a, sigma, 0.10, interpret=True)
        ref_T = np.asarray(jsolver.fused_seed_transforms(
            *a, sigma, 0.10, interpret=True))
        np.testing.assert_allclose(got_w[b].numpy(), np.asarray(ref_w),
                                   atol=1e-5)
        Tg = got_T[b].numpy()
        np.testing.assert_allclose(Tg[:, :3, :3], ref_T[:, :3, :3], atol=5e-4)
        np.testing.assert_allclose(Tg[:, :3, 3], ref_T[:, :3, 3], atol=5e-3)
        np.testing.assert_array_equal(Tg[:, 3], ref_T[:, 3])


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
