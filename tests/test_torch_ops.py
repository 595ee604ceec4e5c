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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("extent", [2.5, 120.0])
def test_compat_cache_is_exactly_symmetric(rng, extent, dtype):
    """The cache kernel computes each tile pair (I, J), I <= J, once and
    stores the tile at (I, J) and its transpose at (J, I). That rests on
    c(i, j) == c(j, i) bit for bit: a - b is exactly -(b - a), so the
    squares and sums run on the same values in the same order. Held here
    on the plain version, which rounds every operation as the kernel does,
    at N = 333 (no multiple of a tile) and at metre and 120 m extents
    (sigma_d 0.10 / 1.2). A third of the points keep their place (tgt =
    src) and a third are mirrored (tgt = -src): pairs within either group
    have ds2 == dt2 exactly, where the one-sqrt int8 form's clamp at 0
    decides."""
    B, N = 2, 333
    src = (rng.rand(B, N, 3) * extent).astype(np.float32)
    tgt = (src + 0.01 * extent * rng.randn(B, N, 3)).astype(np.float32)
    tgt[:, :111] = src[:, :111]
    tgt[:, 111:222] = -src[:, 111:222]
    sigma_d = 0.10 if extent < 10 else 1.2
    cache = build_compat_cache(_t(src), _t(tgt), sigma_d, dtype)
    c = cache[:, :, :N]
    assert torch.equal(c, c.transpose(1, 2))
    assert not cache[:, :, N:].any()
    ds2 = ((src[:, :, None] - src[:, None]) ** 2).sum(-1)
    dt2 = ((tgt[:, :, None] - tgt[:, None]) ** 2).sum(-1)
    assert (ds2 == dt2).mean() > 0.2  # the equal-distance pairs are there
    assert 0.02 < (c.float() > c.float().min()).float().mean() < 1.0


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


def test_fused_seed_transforms_svd_matches_pallas_interpret(rng):
    """kabsch_method="svd" after the same weights, against gmf_tpu's in
    interpret mode with the bounds above; it also agrees with "quat" to
    the same bounds."""
    feats, src, tgt = _seed_problem(rng, 1, 13, 16, 32)
    got = fused_seed_transforms(_t(feats), _t(src), _t(tgt), 1.2, 0.10,
                                kabsch_method="svd")[0].numpy()
    quat = fused_seed_transforms(_t(feats), _t(src), _t(tgt), 1.2,
                                 0.10)[0].numpy()
    a = [jnp.asarray(x[0]) for x in (feats, src, tgt)]
    ref = np.asarray(jsolver.fused_seed_transforms(
        *a, 1.2, 0.10, interpret=True, kabsch_method="svd"))
    for want in (ref, quat):
        np.testing.assert_allclose(got[:, :3, :3], want[:, :3, :3], atol=5e-4)
        np.testing.assert_allclose(got[:, :3, 3], want[:, :3, 3], atol=5e-3)
    np.testing.assert_array_equal(got[:, 3], ref[:, 3])


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


def _first_kept(x, lo, hi, skip):
    """The kernel's binary search: the first index of [lo, hi) at which
    ``skip`` (true on a prefix) is false."""
    while lo < hi:
        mid = lo + (hi - lo) // 2
        if skip(x[mid]):
            lo = mid + 1
        else:
            hi = mid
    return lo


def _x_sorted(pts, scores):
    """The NMS kernel's sort (gmf_nms_sort) for points with no -0 or
    negative NaN x: each pair's points by x, ties by index, NaN last,
    packed as (x, y, z, score), and the pair index of each."""
    order = torch.sort(pts[..., 0], dim=1, stable=True).indices
    packed = torch.cat([pts, scores[..., None]], dim=-1)
    keys = torch.take_along_dim(packed, order[..., None], dim=1)
    return keys, order.to(torch.int32)


def _nms_sweep_schedule(keys, order, radius, rows=128):
    """The NMS kernel's schedule (csrc/nms_local_max.cu) on the CPU, from
    the sorted keys and order (_x_sorted): per block of ``rows`` sorted points
    the range of keys its two binary searches keep (the rounded x
    predicates, in f32), the rounded distances and the strict score test
    on that range only, written back in each pair's own order. Returns
    is_local_max and the share of (i, j) the ranges skip."""
    B, N, _ = keys.shape
    r2 = torch.tensor(float(radius) ** 2, dtype=torch.float32)
    out, skipped = torch.empty(B, N), 0
    for b in range(B):
        x = keys[b, :, 0]
        for r0 in range(0, N, rows):
            last = min(r0 + rows, N) - 1
            start = _first_kept(
                x, 0, r0, lambda xj: bool((x[r0] - xj) ** 2 >= r2))
            end = _first_kept(
                x, last + 1, N, lambda xj: not bool((xj - x[last]) ** 2 >= r2))
            me, ks = keys[b, r0:last + 1], keys[b, start:end]
            d = [me[:, None, c] - ks[None, :, c] for c in range(3)]
            d2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
            sup = ((d2 < r2) & (ks[None, :, 3] > me[:, None, 3])).any(-1)
            out[b, order[b, r0:last + 1].long()] = (~sup).float()
            skipped += (last + 1 - r0) * (N - (end - start))
    return out, skipped / (B * N * N)


@pytest.mark.parametrize("N", [300, 1000])
def test_nms_sweep_matches_plain_and_pallas_interpret(rng, N):
    """The NMS kernel's x sweep skips keys by their x alone: equal in
    every bit to the dense plain version and to the Pallas kernel in
    interpret mode. Ragged N (no multiple of the 128-point blocks); a
    third of the points on a lattice of half the radius, so many pairs lie
    at exactly the radius (squared distances exact, equal to R^2: no
    suppression) and many share an x (ties in the sort); scores drawn from
    20 values (ties never suppress) with one pair's scores negative; a NaN
    and an infinite x in pair 0 (sorted last; never suppressed, never
    suppressing)."""
    B, radius = 2, 0.25
    pts = (rng.rand(B, N, 3) * 3).astype(np.float32)
    lattice = rng.randint(0, 6, size=(B, N // 3, 3)).astype(np.float32)
    pts[:, : N // 3] = lattice * (radius / 2)
    scores = rng.randint(0, 20, size=(B, N)).astype(np.float32) / 20
    scores[1] -= 0.5
    pts[0, 1, 0], pts[0, 2, 0] = np.nan, np.inf
    keys, order = _x_sorted(_t(pts), _t(scores))
    got, skipped = _nms_sweep_schedule(keys, order, radius)
    ref = nms_local_max_plain(_t(pts), _t(scores), radius)
    assert torch.equal(got, ref)
    assert torch.equal(nms_local_max(_t(pts), _t(scores), radius), ref)
    for b in range(B):
        want = jnms.nms_local_max(jnp.asarray(pts[b]), jnp.asarray(scores[b]),
                                  radius=radius, block_q=128, block_k=128,
                                  interpret=True)
        np.testing.assert_array_equal(got[b].numpy(), np.asarray(want))
    # the lattice puts pairs at exactly the radius, and the sweep skips
    with np.errstate(invalid="ignore"):
        d2 = ((pts[:, :, None] - pts[:, None]) ** 2).sum(-1)
    assert (d2 == radius ** 2).sum() > 200
    assert 0 < ref.mean() < 1 and skipped > 0.3


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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["plain", "ties", "exhausted", "k128"])
def test_seed_knn_topk_matches_pallas_interpret(rng, case, dtype):
    """Indices equal to the Pallas kernel's in interpret mode, both fed the
    same f32 or bf16 features (bf16: exact products, f32 sums); k up to
    the kernel's width of 128."""
    B, S, N, C = 2, 24, 200, 32
    k = 128 if case == "k128" else 11
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
    got, _ = seed_knn_topk(_t(seeds).to(getattr(torch, dtype)),
                           _t(feats).to(getattr(torch, dtype)), k,
                           mask=_t(mask))
    for b in range(B):
        ref, _ = jtopk.seed_knn_topk(jnp.asarray(seeds[b], dtype),
                                     jnp.asarray(feats[b], dtype), k,
                                     mask=jnp.asarray(mask[b]),
                                     interpret=True)
        np.testing.assert_array_equal(got[b].numpy(), np.asarray(ref))


def _scoring_problem(rng, B=2, S=40, N=300, thr=0.10, extent=3.0,
                     turn=0.05, shift=0.05, noise=0.08, edge=1e-4,
                     centred=False):
    """Hypotheses turned by ~``turn`` rad about z and shifted by ~``shift``
    from the identity, src in a cube of side ``extent`` (``centred``: about
    the origin), tgt = src + ``noise`` gaussian; pair 1's last 50 points
    masked, and every point within ``edge`` of the threshold under some
    seed: only the float knife-edge may differ between the residual and
    the bilinear form."""
    src = rng.rand(B, N, 3) * extent - (extent / 2 if centred else 0.0)
    src = src.astype(np.float32)
    T = np.tile(np.eye(4, dtype=np.float32), (B, S, 1, 1))
    for b in range(B):
        for s in range(S):
            ang = turn * rng.randn(3)
            c, sn = np.cos(ang[2]), np.sin(ang[2])
            T[b, s, :3, :3] = np.array([[c, -sn, 0], [sn, c, 0], [0, 0, 1]])
            T[b, s, :3, 3] = shift * rng.randn(3)
    tgt = (src + noise * rng.randn(B, N, 3)).astype(np.float32)
    mask = np.ones((B, N), np.float32)
    mask[1, N - 50:] = 0.0
    res = (np.einsum("bsij,bnj->bsni", T[..., :3, :3].astype(np.float64),
                     src) + T[:, :, None, :3, 3] - tgt[:, None])
    d = np.linalg.norm(res, axis=-1)
    mask[(np.abs(d - thr) < edge).any(1)] = 0.0
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


def test_seed_hypothesis_counts_matches_pallas_interpret_kitti(rng):
    """KITTI LiDAR scale: coordinates of tens of metres (+-40 m), the 0.6 m
    threshold. The bilinear form rounds d^2 to ~eps |coords|^2 (~1e-3 m^2
    here, gmf_tpu/ops/fused_scoring.py:33-45, ~2 mm in d at 0.6 m), so
    points within 5 mm of the threshold under some seed are masked; every
    other count equals the Pallas kernel's."""
    T, src, tgt, mask = _scoring_problem(
        rng, S=24, thr=0.6, extent=80.0, centred=True, turn=0.002,
        shift=0.05, noise=0.35, edge=5e-3)
    assert mask.mean() > 0.6
    got = seed_hypothesis_counts(_t(T), _t(src), _t(tgt), 0.6, mask=_t(mask))
    for b in range(T.shape[0]):
        ref = jscore.seed_hypothesis_counts(
            jnp.asarray(T[b]), jnp.asarray(src[b]), jnp.asarray(tgt[b]),
            0.6, mask=jnp.asarray(mask[b]), interpret=True)
        np.testing.assert_array_equal(got[b].numpy(),
                                      np.asarray(ref).astype(np.int32))
    assert 0 < int(got.min()) and int(got.max()) < int(mask.sum(-1).min())


@pytest.mark.parametrize("scale", ["3dmatch", "kitti"])
def test_seed_hypothesis_counts_plain_is_the_kernel_order(rng, scale):
    """The plain counts are the CUDA kernel's operations, each a rounded
    f32 operation, in its order: per coordinate ((R0 x + R1 y) + R2 z) + t
    - u, then (px^2 + py^2) + pz^2, no matrix product, no fused
    multiply-add. numpy's f32 ufuncs evaluated in that order give the same
    squared residuals in every bit, and so the same counts."""
    from gmf_tpu_torch.ops.fused_scoring import seed_residuals_sq_plain

    kitti = scale == "kitti"
    thr = 0.6 if kitti else 0.10
    T, src, tgt, mask = _scoring_problem(
        rng, thr=thr, extent=80.0 if kitti else 3.0, centred=kitti,
        turn=0.002 if kitti else 0.05, noise=0.35 if kitti else 0.08,
        edge=0.0)
    T[0, 0, :3, :3] = 0.0  # a degenerate hypothesis: every point at t0
    got = seed_residuals_sq_plain(_t(T), _t(src), _t(tgt))
    assert got.dtype == torch.float32
    x, y, z = (src[:, None, :, c] for c in range(3))

    def coord(r):
        R = T[:, :, r, :, None]
        return ((R[:, :, 0] * x + R[:, :, 1] * y) + R[:, :, 2] * z
                + R[:, :, 3]) - tgt[:, None, :, r]

    px, py, pz = coord(0), coord(1), coord(2)
    ref = (px * px + py * py) + pz * pz
    assert ref.dtype == np.float32
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  ref.view(np.uint32))
    counts = seed_hypothesis_counts(_t(T), _t(src), _t(tgt), thr,
                                    mask=_t(mask))
    want = ((ref < np.float32(thr * thr)) & (mask[:, None] > 0)).sum(-1)
    np.testing.assert_array_equal(counts.numpy(), want.astype(np.int32))
    assert 0 < int(counts.max()) < int(mask.sum(-1).max())


def _split3(x):
    """x (f32) as hi + mid + lo, each a bf16 value held in f32: hi =
    bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid); both
    subtractions are exact in f32."""
    hi = x.to(torch.bfloat16).float()
    mid = (x - hi).to(torch.bfloat16).float()
    lo = (x - hi - mid).to(torch.bfloat16).float()
    return hi, mid, lo


def _split_product(a, b, terms):
    """a @ b from the bf16 terms as the cached backward kernels form an f32
    product on the tensor cores: every bf16 x bf16 product is exact in f32,
    the term products are summed in f32, smallest first. ``terms`` 6: lo.hi
    + hi.lo + mid.mid + mid.hi + hi.mid + hi.hi; 3: the last three only."""
    pa, pb = _split3(a), _split3(b)
    order = ((2, 0), (0, 2), (1, 1), (1, 0), (0, 1), (0, 0))[6 - terms:]
    acc = torch.zeros(a.shape[0], b.shape[1])
    for i, j in order:
        acc = acc + pa[i] @ pb[j]
    return acc


@pytest.mark.parametrize("contraction", ["s_t", "dv"])
def test_three_term_bf16_split_keeps_f32_accuracy(rng, contraction):
    """The error model behind holding the f32 cached backward to 1e-5 of
    its plain version on the tensor cores. At the training shape (N=1000
    queries and keys, D=128) the six-term product stays within f32's own
    error against f64 on S^T = k qs^T (depth D) and on dV = P^T do (depth
    N, P a softmax); dropping mid.mid, hi.lo and lo.hi does not (the issue's
    emulation: 1.7e-7 six, 4.7e-6 three, 5.0e-7 f32, of the largest
    entry)."""
    N, D = 1000, 128
    if contraction == "s_t":
        k, q = (torch.tensor(rng.randn(N, D).astype(np.float32))
                for _ in range(2))
        a, b = k, (q * (1.4426950408889634 / np.sqrt(D))).T.contiguous()
    else:
        logits = torch.tensor(2 * rng.randn(N, N).astype(np.float32))
        a = torch.softmax(logits, -1).T.contiguous()
        b = torch.tensor(rng.randn(N, D).astype(np.float32))
    exact = a.double() @ b.double()
    scale = exact.abs().max().item()

    def err(x):
        return (x.double() - exact).abs().max().item() / scale

    f32 = err(a @ b)
    assert err(_split_product(a, b, 6)) <= 2 * f32
    assert err(_split_product(a, b, 3)) > 5 * f32


def _truncate_f32(x64):
    """f64 -> f32 rounded toward zero: the model of the tensor cores'
    truncating f32 accumulation."""
    y = x64.float()
    over = y.double().abs() > x64.abs()
    return torch.where(over, torch.nextafter(y, torch.zeros_like(y)), y)


def _wgmma_steps(acc, a_terms, b_terms, terms):
    """acc += A B as wgmma forms it from split operands: for each term
    product, smallest first, and each 16-deep k-step, the step's exact
    sum added to the f32 accumulator and the result truncated to f32."""
    order = ((2, 0), (0, 2), (1, 1), (1, 0), (0, 1), (0, 0))[6 - terms:]
    for i, j in order:
        a, b = a_terms[i].double(), b_terms[j].double()
        for k0 in range(0, a.shape[1], 16):
            acc = _truncate_f32(acc.double() + a[:, k0:k0 + 16]
                                @ b[k0:k0 + 16])
    return acc


def _f32_forward_schedule(qs, k, v, compat, key_state, terms=6,
                          straight=False):
    """The f32 forward kernel's schedule (csrc/compat_flash_core.cuh,
    compat_flash_fwd_split) for one pair on the CPU: qs, k, v split into
    three bf16 terms, 32-key tiles, S from the term products, compat and
    the key states (1 valid, 0 masked, -1 past N), the online base-2
    softmax, p split into three terms and each tile's P V into a zeroed
    tile sum added to the rescaled O with a rounded f32 add (``straight``:
    into O itself). k, v and compat are padded to whole tiles."""
    n = qs.shape[0]
    m = torch.full((n,), -float("inf"))
    l, o = torch.zeros(n), torch.zeros(n, v.shape[1])
    q3 = _split3(qs)
    for k0 in range(0, k.shape[0], 32):
        ks = slice(k0, k0 + 32)
        s = _wgmma_steps(torch.zeros(n, 32), q3,
                         _split3(k[ks].T.contiguous()), terms)
        logit = compat[:, ks] * s
        logit = torch.where(key_state[ks] == 0, torch.full_like(logit, -1e9),
                            logit)
        logit = torch.where(key_state[ks] < 0,
                            torch.full_like(logit, -float("inf")), logit)
        m_next = torch.maximum(m, logit.amax(-1))
        alpha = torch.where(m == -float("inf"), torch.zeros_like(m),
                            torch.exp2(m - m_next))
        p = torch.exp2(logit - m_next[:, None])
        l, m = alpha * l + p.sum(-1), m_next
        o = o * alpha[:, None]
        p3, v3 = _split3(p), _split3(v[ks])
        if straight:
            o = _wgmma_steps(o, p3, v3, terms)
        else:
            o = o + _wgmma_steps(torch.zeros_like(o), p3, v3, terms)
    return o / torch.clamp(l, min=1e-30)[:, None]


def test_f32_forward_schedule_keeps_f32_accuracy(rng):
    """The error model behind holding the f32 forward attention to 1e-5
    of its plain version on the tensor cores. At the training shape (N =
    1000 queries and keys, D = 128, the streaming compat, the last tenth
    of the keys masked), with wgmma's f32 accumulation modelled as
    truncating after every 16-deep step, the kernel's schedule (six term
    products, each tile's P V into a zeroed tile sum) stays within f32's
    own error of an f64 attention (twice the plain f32 version's, as for
    the backward's split) and within 1e-5 of compat_attention_plain.
    Dropping mid.mid, hi.lo and lo.hi, or accumulating P V straight into
    O, does not, and lies at least 3 times farther from f64 than the
    kernel's schedule. In this model, relative to the largest output
    (0.31): 1.0e-6 six with tile sums, 5.7e-6 three, 1.2e-5 straight,
    1.3e-6 the plain f32 version; the kernel's schedule lies 4.2e-7 from
    the plain version."""
    from gmf_tpu_torch.ops.fused_attention import (_qscale,
                                                   _stream_compat_plain,
                                                   compat_attention_plain)

    N, D, tiles = 1000, 128, 1024
    q, k, v = (torch.tensor(rng.randn(1, N, D).astype(np.float32))
               for _ in range(3))
    src = torch.tensor((rng.rand(1, N, 3) * 2.5).astype(np.float32))
    tgt = src + torch.tensor(0.02 * rng.randn(1, N, 3).astype(np.float32))
    mask = torch.ones(1, N)
    mask[0, N - N // 10:] = 0.0
    compat = _stream_compat_plain(src, tgt, 0.10)[0]
    plain = compat_attention_plain(q, k, v, src, tgt, mask)[0]

    qs64 = q[0].double() * (1.4426950408889634 / np.sqrt(D))
    logits = compat.double() * (qs64 @ k[0].double().T)
    logits = torch.where(mask[0] > 0, logits, torch.full_like(logits, -1e9))
    p = torch.exp2(logits - logits.amax(-1, keepdim=True))
    exact = (p @ v[0].double()) / p.sum(-1, keepdim=True)
    scale = exact.abs().max().item()

    def err(x):
        return (x.double() - exact).abs().max().item() / scale

    def pad(x, cols=False):
        out = torch.zeros((x.shape[0], tiles) if cols
                          else (tiles, x.shape[1]))
        if cols:
            out[:, :N] = x
        else:
            out[:N] = x
        return out

    state = torch.full((tiles,), -1.0)
    state[:N] = mask[0]
    args = (q[0] * _qscale(D), pad(k[0]), pad(v[0]), pad(compat, True),
            state)
    f32, kernel = err(plain), _f32_forward_schedule(*args)
    assert err(kernel) <= 2 * f32
    assert (kernel - plain).abs().max().item() <= 1e-5
    for worse in (_f32_forward_schedule(*args, terms=3),
                  _f32_forward_schedule(*args, straight=True)):
        assert err(worse) > 2 * f32 and err(worse) > 3 * err(kernel)


def _seed_gram_model(f, terms):
    """The seed solver kernel's Gram (csrc/fused_seed_weights.cu) on the
    CPU: f [..., k, C] as ``terms`` bf16 terms (3: hi, mid, lo; 1: f is
    bf16-valued), mma.sync's 16-deep k-steps in order, each step's term
    products smallest first, every step's exact sum added to the f32
    accumulator and the result truncated to f32 (the tensor cores'
    accumulation, as in _wgmma_steps). One term: hi = bf16(f) alone."""
    parts = _split3(f) if terms == 3 else (f.to(torch.bfloat16).float(),)
    order = ((2, 0), (0, 2), (1, 1), (1, 0), (0, 1), (0, 0))[
        0 if terms == 3 else 5:]
    acc = torch.zeros(f.shape[:-1] + f.shape[-2:-1])
    for k0 in range(0, f.shape[-1], 16):
        for i, j in order:
            a = parts[i][..., k0:k0 + 16].double()
            b = parts[j][..., k0:k0 + 16].double()
            acc = _truncate_f32(acc.double() + a @ b.transpose(-1, -2))
    return acc


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,k,C", [(24, 40, 128), (12, 17, 32), (6, 128, 48)])
def test_seed_solver_split_gram_keeps_f32_accuracy(rng, S, k, C, dtype):
    """The error model behind holding the tensor-core seed solver to 1e-5
    of fused_seed_weights_plain. f32 features: the three-term split, six
    products straight into the f32 accumulator, lies within 4x the plain
    f32 Gram's distance from f64 (measured ~1.9x), and the weights from it
    (through the plain chain, ``weights_from_gram``) within 1e-5 of the
    plain version's and within twice the plain version's distance from the
    chain in f64; the hi term alone lies over 100x farther, in its Gram and
    in its weights (measured 1400-5000x; 1e-5 of the plain weights does not
    tell it apart: 0.85-1.1e-5 at k = 128), which is why chip_smoke.py
    holds the kernel's f32 instance to the f64 chain too. bf16 features:
    one term, every product exact in f32."""
    from gmf_tpu_torch.ops.fused_seed_solver import (fused_seed_weights_plain,
                                                     weights_from_gram)

    feats, src, tgt = _seed_problem(rng, 1, S, k, C)
    # neighbourhoods of related features, so that feat_M is not all zero
    feats = feats + 1.5 * rng.randn(1, S, 1, C).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=-1, keepdims=True)
    f = _t(feats).to(dtype).float()
    s, t = _t(src), _t(tgt)
    exact = f.double() @ f.double().transpose(-1, -2)

    def err(g):
        return (g.double() - exact).abs().max().item()

    model = _seed_gram_model(f, 3 if dtype == torch.float32 else 1)
    ref = fused_seed_weights_plain(f.to(dtype), s, t, 1.2, 0.10)
    got = weights_from_gram(model, s, t, 1.2, 0.10)
    assert (got - ref).abs().max().item() <= 1e-5
    assert 0 < ref.max().item()
    plain = err(f @ f.transpose(-1, -2))
    assert err(model) <= 4 * plain
    exact_w = weights_from_gram(exact, s.double(), t.double(), 1.2, 0.10)

    def err_w(w):
        return (w.double() - exact_w).abs().max().item()

    assert exact_w.dtype == torch.float64
    assert err_w(got) <= 2 * err_w(ref)
    if dtype == torch.float32:
        one_term = _seed_gram_model(f, 1)
        assert err(one_term) > 100 * err(model)
        assert err_w(weights_from_gram(one_term, s, t, 1.2, 0.10)) > \
            100 * err_w(ref)
