"""gmf_tpu_torch geometry vs gmf_tpu on the same NumPy inputs (CPU, f32).

Tolerance 1e-5 absolute: both sides run the same f32 formulas; only the
summation order of tiny matmuls differs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gmf_tpu.geometry import kabsch as jkabsch
from gmf_tpu.geometry import nms as jnms
from gmf_tpu.geometry import se3 as jse3
from gmf_tpu.geometry import spectral as jspectral
from gmf_tpu_torch.geometry import kabsch, nms, se3, spectral

torch.set_num_threads(1)
ATOL = 1e-5


def _t(x):
    return torch.tensor(np.asarray(x, np.float32))


def _random_trans(rng, B):
    T = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    for b in range(B):
        T[b, :3, :3] = jse3.random_rotation_matrix(3, 1.0, rng)
        T[b, :3, 3] = rng.rand(3)
    return T


def _alignment_problem(rng, B=8, K=40):
    A = rng.rand(B, K, 3).astype(np.float32) * 2.5
    T = _random_trans(rng, B)
    Bp = (A @ T[:, :3, :3].transpose(0, 2, 1) + T[:, None, :3, 3]
          + 0.01 * rng.randn(B, K, 3)).astype(np.float32)
    w = rng.rand(B, K).astype(np.float32)
    w[:, :5] = 0.0
    return A, Bp, w


def test_se3_transform_and_integrate(rng):
    pts = rng.rand(4, 50, 3).astype(np.float32) * 3
    T = _random_trans(rng, 4)
    np.testing.assert_allclose(se3.transform(_t(pts), _t(T)).numpy(),
                               np.asarray(jse3.transform(pts, T)), atol=ATOL)
    R, t = T[:, :3, :3], T[:, :3, 3]
    np.testing.assert_array_equal(
        se3.integrate_trans(_t(R), _t(t)).numpy(),
        np.asarray(jse3.integrate_trans(R, t)))


def test_se3_host_sampling_same_draws():
    a, b = np.random.RandomState(3), np.random.RandomState(3)
    for axes in (1, 3):
        np.testing.assert_array_equal(se3.random_rotation_matrix(axes, 1, a),
                                      jse3.random_rotation_matrix(axes, 1, b))
    np.testing.assert_array_equal(se3.random_translation(1.0, a),
                                  jse3.random_translation(1.0, b))


@pytest.mark.parametrize("method", ["quat", "svd"])
def test_rigid_transform_3d(rng, method):
    A, Bp, w = _alignment_problem(rng)
    got = kabsch.rigid_transform_3d(_t(A), _t(Bp), _t(w), method=method)
    ref = jkabsch.rigid_transform_3d(A, Bp, w, method=method)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("method", ["quat", "svd"])
def test_rigid_transform_3d_weight_threshold(rng, method):
    """Weights below the threshold (here about half of them) count as 0,
    as in gmf_tpu's; the result then differs from the unclipped one."""
    A, Bp, w = _alignment_problem(rng)
    Bp[:, 5:20] += 0.3 * rng.randn(8, 15, 3).astype(np.float32)
    got = kabsch.rigid_transform_3d(_t(A), _t(Bp), _t(w),
                                    weight_threshold=0.5, method=method)
    ref = jkabsch.rigid_transform_3d(A, Bp, w, weight_threshold=0.5,
                                     method=method)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)
    clipped = kabsch.rigid_transform_3d(
        _t(A), _t(Bp), _t(np.where(w < 0.5, 0.0, w)), method=method)
    np.testing.assert_array_equal(got.numpy(), clipped.numpy())
    unclipped = kabsch.rigid_transform_3d(_t(A), _t(Bp), _t(w),
                                          method=method)
    assert np.abs(got.numpy() - unclipped.numpy()).max() > 1e-3


def test_leading_eigvec_4x4(rng):
    A, Bp, w = _alignment_problem(rng)
    H, _, _ = jkabsch._weighted_cross_covariance(A, Bp, w)
    Nm = np.asarray(jkabsch._horn_quaternion_matrix(H))
    np.testing.assert_allclose(
        kabsch._horn_quaternion_matrix(_t(np.asarray(H))).numpy(), Nm,
        atol=ATOL)
    np.testing.assert_allclose(
        kabsch._leading_eigvec_4x4(_t(Nm)).numpy(),
        np.asarray(jkabsch._leading_eigvec_4x4(Nm)), atol=ATOL)


def test_kabsch_quat_matches_svd(rng):
    A, Bp, w = _alignment_problem(rng)
    np.testing.assert_allclose(
        kabsch.kabsch_quat(_t(A), _t(Bp), _t(w)).numpy(),
        kabsch.kabsch_svd(_t(A), _t(Bp), _t(w)).numpy(), atol=1e-4)


@pytest.mark.parametrize("num_iters", [2, 10])
def test_leading_eigenvector_global_exit(rng, num_iters):
    """Blocks converge at different rates; the loop stops only when ALL
    blocks have, so fast blocks keep iterating (spectral.py:45)."""
    M = rng.rand(12, 20, 20).astype(np.float32)
    M = M + M.transpose(0, 2, 1)
    M[:4] = np.eye(20, dtype=np.float32)[None] + 0.01 * M[:4]  # fast blocks
    got = spectral.leading_eigenvector(_t(M), num_iters=num_iters)
    ref = jspectral.leading_eigenvector(jnp.asarray(M), num_iters=num_iters)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("num_iters", [3, 10])
def test_leading_eigenvector_fixed(rng, num_iters):
    """No convergence test: exactly num_iters rounds, also for blocks
    that converged at once."""
    M = rng.rand(12, 20, 20).astype(np.float32)
    M = M + M.transpose(0, 2, 1)
    M[:4] = np.eye(20, dtype=np.float32)[None] + 0.01 * M[:4]
    M[4] = 0.0  # an all-zero block stays zero (no NaN)
    got = spectral.leading_eigenvector_fixed(_t(M), num_iters=num_iters)
    ref = jspectral.leading_eigenvector_fixed(jnp.asarray(M),
                                              num_iters=num_iters)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)
    assert np.isfinite(got.numpy()).all() and (got[4] == 0).all()


def test_pick_seeds_nms_dense(rng):
    B, N = 2, 200
    pts = rng.rand(B, N, 3).astype(np.float32) * 2
    scores = rng.randn(B, N).astype(np.float32)
    mask = np.ones((B, N), np.float32)
    mask[1, 150:] = 0
    d = np.linalg.norm(pts[:, :, None] - pts[:, None], axis=-1)
    got = nms.pick_seeds_nms(_t(d), _t(scores), 0.15, 60, mask=_t(mask))
    ref = jnms.pick_seeds_nms(jnp.asarray(d), jnp.asarray(scores), 0.15, 60,
                              mask=jnp.asarray(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_topk_total_order_signed_zeros():
    x = np.array([[-0.0, 0.0, -0.0, 0.0, -1.0, 0.5, -np.inf, 0.5]],
                 np.float32)
    got = nms.topk_total_order(_t(x), 8).numpy()
    _, ref = jax.lax.top_k(jnp.asarray(x), 8)
    np.testing.assert_array_equal(got, np.asarray(ref))
    np.testing.assert_array_equal(got[0, :6], [5, 7, 1, 3, 0, 2])


def test_rigid_transform_3d_gradients_match_jax_grad(rng):
    """Gradients through the quaternion Kabsch with respect to the points
    and the weights, as the seed solver's training path takes them,
    against jax.grad of the reference on the same scalar of the transform.
    Repeated squaring makes the eigenvector's gradient a long product of
    f32 4x4 matmuls: 1e-4 of the largest entry."""
    A, Bp, w = _alignment_problem(rng)
    proj = rng.randn(4, 4).astype(np.float32)

    def jloss(a, b, ww):
        return jnp.sum(jkabsch.rigid_transform_3d(a, b, ww) * proj)

    ref = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (A, Bp, w)))
    leaves = [_t(x).requires_grad_() for x in (A, Bp, w)]
    (kabsch.rigid_transform_3d(*leaves) * _t(proj)).sum().backward()
    for r, x in zip(ref, leaves):
        r = np.asarray(r)
        np.testing.assert_allclose(x.grad.numpy(), r,
                                   atol=1e-4 * np.abs(r).max())


def test_leading_eigenvector_fixed_gradient_matches_jax_grad(rng):
    """The fixed-count power iteration that the train branch takes, its
    gradient with respect to the matrix against jax.grad, to f32 rounding
    of ten normalised matvecs: 1e-5 of the largest entry."""
    x = rng.rand(6, 12, 5).astype(np.float32)
    M = np.clip(x @ x.transpose(0, 2, 1) / 5, 0, 1).astype(np.float32)
    proj = rng.randn(6, 12).astype(np.float32)

    def jloss(m):
        return jnp.sum(jspectral.leading_eigenvector_fixed(m, 10) * proj)

    ref = np.asarray(jax.grad(jloss)(jnp.asarray(M)))
    m = _t(M).requires_grad_()
    (spectral.leading_eigenvector_fixed(m, 10) * _t(proj)).sum().backward()
    np.testing.assert_allclose(m.grad.numpy(), ref,
                               atol=1e-5 * np.abs(ref).max())


# -- gmf_tpu/geometry/metrics.py and se3's composition, held to 1e-5 as
# above (the same f32 formulas; the acos of a cosine near 1 magnifies its
# last bit, so the angles are compared at 1e-3 deg)

def _near_trans(rng, T, scale):
    """T perturbed by a small rotation and translation (a registration
    close to the truth, as the success test sees)."""
    D = _random_trans(rng, len(T))
    for b in range(len(T)):
        D[b, :3, :3] = jse3.random_rotation_matrix(3, scale, rng)
        D[b, :3, 3] = scale * rng.randn(3)
    return np.einsum("bij,bjk->bik", D, T).astype(np.float32)


@pytest.mark.parametrize("fn", ["concatenate", "inverse"])
def test_se3_compose_and_inverse(rng, fn):
    T1, T2 = _random_trans(rng, 6), _random_trans(rng, 6)
    args = (T1, T2) if fn == "concatenate" else (T1,)
    got = getattr(se3, fn)(*map(_t, args)).numpy()
    np.testing.assert_allclose(got, np.asarray(getattr(jse3, fn)(*args)),
                               atol=ATOL)


def test_registration_metrics(rng):
    from gmf_tpu.geometry import metrics as jmetrics
    from gmf_tpu_torch.geometry import metrics

    T = _random_trans(rng, 16)
    P = _near_trans(rng, T, 0.01)
    ok, re, te = metrics.registration_success(_t(P), _t(T), 3.0, 0.02)
    jok, jre, jte = jmetrics.registration_success(P, T, 3.0, 0.02)
    assert 0 < int(np.sum(jok)) < 16
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    np.testing.assert_allclose(re.numpy(), np.asarray(jre), atol=1e-3)
    np.testing.assert_allclose(te.numpy(), np.asarray(jte), atol=ATOL)
    np.testing.assert_allclose(
        metrics.rotation_error_deg(_t(P[:, :3, :3]), _t(T[:, :3, :3])),
        np.asarray(jmetrics.rotation_error_deg(P[:, :3, :3], T[:, :3, :3])),
        atol=1e-3)
    np.testing.assert_allclose(
        metrics.translation_error(_t(P[:, :3, 3:]), _t(T[:, :3, 3:])),
        np.asarray(jmetrics.translation_error(P[:, :3, 3:], T[:, :3, 3:])),
        atol=ATOL)
    xyz0 = rng.rand(16, 30, 3).astype(np.float32) * 2
    xyz1 = (xyz0 + 0.05 * rng.randn(16, 30, 3)).astype(np.float32)
    w = rng.rand(16, 30).astype(np.float32)
    for kw in (dict(), dict(max_dist=0.5)):
        for weight in (None, w):
            np.testing.assert_allclose(
                metrics.corr_dist(_t(T), _t(xyz0), _t(xyz1),
                                  None if weight is None else _t(weight),
                                  **kw).numpy(),
                np.asarray(jmetrics.corr_dist(T, xyz0, xyz1, weight, **kw)),
                atol=ATOL)
    pred = rng.rand(4, 50) > 0.5
    gt = rng.rand(4, 50) > 0.4
    mask = rng.rand(4, 50) > 0.3
    for m in (None, mask):
        got = metrics.precision_recall_f1(
            torch.from_numpy(pred), torch.from_numpy(gt),
            None if m is None else torch.from_numpy(m))
        ref = jmetrics.precision_recall_f1(pred, gt, m)
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


def test_geometry_exports_as_gmf_tpu():
    import gmf_tpu.geometry as jgeometry
    import gmf_tpu_torch.geometry as geometry

    public = {n for n in dir(jgeometry) if not n.startswith("_")
              and callable(getattr(jgeometry, n))}
    assert public - set(dir(geometry)) == set()
    assert geometry.inverse is se3.inverse
