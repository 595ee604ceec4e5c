"""gmf_tpu_torch's DGR+GMF engine (models/dgr.py, ops/fpfh.py, the DGR
loss, loaders and the test_dgr command line) vs gmf_tpu on the same
inputs and bridged weights (CPU, f32).

Nets at gmf_tpu's DGR test widths (channels 4/8/16/32, TR 8/8/8/16,
image_dim 16, voxel 0.1, granules 256). The FCGF net here has a 7^3
conv1: gmf_tpu's engine builds the FCGF pyramid's conv1 map with 7^3
offsets whatever the net's kernel (models/dgr.py, ``_fcgf_features_
device``) and its gather clamps ids past a smaller kernel onto the last
row, where the port builds the net's own kernel; at 7^3 the two agree.

Tolerances, each stated beside its assertion:
- se3_refine: the same iteration count and T within 1e-5 where no stop
  decision sits at its threshold (``test_se3_refine_against_gmf_tpu``
  says why the count may differ where one does);
- register: nn01 equal, weights within 1e-5, T within 1e-4;
- FPFH: normals within 1e-5; features on the same normals within 1e-5
  of their scale; end to end, a histogram entry may change bin only where
  its value lies within 1e-4 of a bin edge, at atan2's branch cut, or
  where Open3D's source swap ties (|a1| within 1e-5 of |a2|).
"""

import logging
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gmf_tpu.data import dgr_loader as jdl
from gmf_tpu.models import dgr as jdgr
from gmf_tpu.ops import fpfh as jfpfh
from gmf_tpu.sparse.kernel_map import build_pyramid as jax_build_pyramid
from gmf_tpu.sparse.resunet import SparseResUNet2 as JaxNet
from gmf_tpu.sparse.resunet import pyramid_to_arrays as jax_arrays
from gmf_tpu.train.losses import high_dim_smooth_l1_loss as jax_hd_loss
from gmf_tpu_torch.data import dgr_loader
from gmf_tpu_torch.data.ply import read_ply, write_ply
from gmf_tpu_torch.models import dgr
from gmf_tpu_torch.ops import fpfh
from gmf_tpu_torch.sparse.resunet import SparseResUNet2
from gmf_tpu_torch.train.losses import high_dim_smooth_l1_loss
from gmf_tpu_torch.utils.bridge import sparse_resunet_to_state_dict
from gmf_tpu_torch.utils.checkpoint import save_checkpoint

torch.set_num_threads(2)
NARROW = dict(channels=(4, 8, 16, 32), tr_channels=(8, 8, 8, 16))
SCENE = "7-scenes-redkitchen"
GOLDEN_FPFH = os.path.join(os.path.dirname(__file__), "golden", "fpfh.npz")


def _t(x):
    return torch.tensor(np.asarray(x))


def _nets(conv1, in_ch=1):
    fkw = dict(in_channels=1, out_channels=8, dim=3, conv1_kernel_size=conv1,
               normalize_feature=True, **NARROW)
    ikw = dict(in_channels=in_ch, out_channels=1, dim=6, conv1_kernel_size=3,
               with_gmf_fusion=True, image_dim=16, **NARROW)
    return fkw, ikw


def _jax_vars(fkw, ikw):
    """gmf_tpu's tiny-engine initialisation (tests/test_dgr.py:75-105)."""
    r = np.random.RandomState(5)
    c3 = np.unique(r.randint(0, 10, (80, 3)).astype(np.int32), axis=0)
    a3 = jax_arrays(jax_build_pyramid(c3, 4, fkw["conv1_kernel_size"],
                                      granule=256))
    fv = jax.jit(JaxNet(**fkw).init)(
        jax.random.PRNGKey(0), jnp.ones((a3["mask_0"].shape[0], 1)), a3)
    c6 = np.unique(r.randint(0, 6, (60, 6)).astype(np.int32), axis=0)
    a6 = jax_arrays(jax_build_pyramid(c6, 4, 3, granule=256))
    img = jnp.zeros((1, 16, 16, 3))
    iv = jax.jit(JaxNet(**ikw).init)(
        jax.random.PRNGKey(1),
        jnp.ones((a6["mask_0"].shape[0], ikw["in_channels"])), a6,
        p_image=img, q_image=img)
    return jax.tree.map(np.asarray, fv), jax.tree.map(np.asarray, iv)


@pytest.fixture(scope="module")
def weights():
    fkw, ikw = _nets(7)
    return fkw, ikw, _jax_vars(fkw, ikw)


def _engines(weights, **cfg):
    fkw, ikw, (fv, iv) = weights
    kw = dict(voxel_size=0.1, voxel_cap_granule=256, corr_cap_granule=256,
              safeguard_ransac_iters=1024, **cfg)
    je = jdgr.DeepGlobalRegistration(
        fv, iv, jdgr.DGRConfig(image_hw=(16, 16), **kw),
        fcgf_model=JaxNet(**fkw),
        inlier_model=JaxNet(**ikw), fcgf_dim=8)
    te = dgr.DeepGlobalRegistration(
        sparse_resunet_to_state_dict(fv), sparse_resunet_to_state_dict(iv),
        dgr.DGRConfig(**kw), fcgf_model=SparseResUNet2(**fkw),
        inlier_model=SparseResUNet2(**ikw), fcgf_dim=8, device="cpu")
    return je, te


@pytest.fixture(scope="module")
def pair():
    p = dgr_loader.make_dgr_pair(np.random.RandomState(3), n_points=800,
                                 voxel_size=0.05, surface=True,
                                 image_hw=(16, 16))
    return p["pcd0"], p["pcd1"], p["p_image"][None], p["q_image"][None]


# -- loss, rotation, refinement ---------------------------------------------


@pytest.mark.parametrize("mode", ["plain", "weights", "mask", "both"])
def test_high_dim_smooth_l1_loss(mode):
    r = np.random.RandomState(0)
    pred, tgt = r.randn(50, 3).astype(np.float32), r.randn(50, 3).astype(
        np.float32)
    kw = {}
    if mode in ("weights", "both"):
        kw["weights"] = r.rand(50).astype(np.float32)
    if mode in ("mask", "both"):
        kw["mask"] = (r.rand(50) > 0.3).astype(np.float32)
    ref = jax_hd_loss(jnp.asarray(pred), jnp.asarray(tgt),
                      quantization_size=0.7,
                      **{k: jnp.asarray(v) for k, v in kw.items()})
    got = high_dim_smooth_l1_loss(_t(pred), _t(tgt), quantization_size=0.7,
                                  **{k: _t(v) for k, v in kw.items()})
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)


def test_ortho6d_to_rotation():
    poses = np.random.RandomState(1).randn(16, 6).astype(np.float32)
    ref = jdgr.ortho6d_to_rotation(jnp.asarray(poses))
    got = dgr.ortho6d_to_rotation(_t(poses))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)
    np.testing.assert_allclose(np.linalg.det(got.numpy()), 1.0, atol=1e-5)


def _rot(a, b=0.0):
    ca, sa, cb, sb = np.cos(a), np.sin(a), np.cos(b), np.sin(b)
    return (np.array([[ca, -sa, 0], [sa, ca, 0], [0, 0, 1]])
            @ np.array([[cb, 0, sb], [0, 1, 0], [-sb, 0, cb]])).astype(
                np.float32)


def _refine_case(case, seed=2):
    r = np.random.RandomState(seed)
    src = (r.rand(300, 3) * 2).astype(np.float32)
    R, t = _rot(0.4, 0.2), np.array([0.3, -0.1, 0.2], np.float32)
    tgt = src @ R.T + t
    w = np.ones(300, np.float32)
    T0 = np.eye(4, dtype=np.float32)
    kw = dict(max_iter=60)
    if case == "exact":  # an exact fit from the start: frozen at once
        T0[:3, :3], T0[:3, 3] = R, t
        return src, tgt, w, T0, kw
    tgt = tgt + 0.002 * r.randn(300, 3).astype(np.float32)
    T0[:3, :3], T0[:3, 3] = _rot(0.1) @ R, t + 0.05
    if case == "outliers":
        tgt[:100] = r.rand(100, 3)
        w[:100] = 0.0
    if case in ("outliers", "to_the_stop"):
        kw = dict(max_iter=1000, break_threshold_ratio=1e-4,
                  quantization_size=0.1)
    return src, tgt, w, T0, kw


@pytest.mark.parametrize("case", ["fixed_steps", "exact", "outliers",
                                  "to_the_stop"])
def test_se3_refine_against_gmf_tpu(case):
    """Adam's steps, the freeze and the stop as gmf_tpu's. "fixed_steps"
    runs all 60 iterations and "exact" freezes at the first: the same
    count, T within 1e-5. Run to the break counter's stop, the count may
    differ: the stop compares relative improvements of ~1e-4 with 1e-4,
    and the loss (a sum of 300 terms) differs in its last bits between
    ATen and XLA:CPU, which shifts the trajectory by ~1e-5 relative
    (measured: counts 146-297 apart by 0-6 over four seeds, T within
    5.7e-5). There the counts must lie within 8 and T within 1e-4."""
    src, tgt, w, T0, kw = _refine_case(case)
    T_j, loss_j, it_j = jdgr.se3_refine(jnp.asarray(src), jnp.asarray(tgt),
                                        jnp.asarray(w), jnp.asarray(T0), **kw)
    T, loss, it = dgr.se3_refine(_t(src), _t(tgt), _t(w), _t(T0), **kw)
    if case in ("fixed_steps", "exact"):
        assert int(it) == int(it_j) == (1 if case == "exact" else 60)
        np.testing.assert_allclose(T.numpy(), np.asarray(T_j), atol=1e-5)
        np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-4,
                                   atol=1e-9)
    else:
        assert int(it) < kw["max_iter"] and int(it_j) < kw["max_iter"]
        assert abs(int(it) - int(it_j)) <= 8
        np.testing.assert_allclose(T.numpy(), np.asarray(T_j), atol=1e-4)


@pytest.mark.parametrize("check_every", [1, 7])
def test_se3_refine_stop_read_late_changes_nothing(check_every):
    """The host reads the device's stop every few iterations; iterations
    after the stop are masked, so every bit equals a loop that read it
    after each iteration."""
    src, tgt, w, T0, kw = _refine_case("outliers")
    args = (_t(src), _t(tgt), _t(w), _t(T0))
    ref = dgr.se3_refine(*args, check_every=1, **kw)
    got = dgr.se3_refine(*args, check_every=check_every, **kw)
    late = dgr.se3_refine(*args, check_every=1000, **kw)
    for a, b, c in zip(got, ref, late):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
        np.testing.assert_array_equal(c.numpy(), b.numpy())
    assert int(ref[2]) < kw["max_iter"]


@pytest.mark.parametrize("feat_type", ["ones", "feats", "coords"])
def test_inlier_input_features(feat_type):
    r = np.random.RandomState(3)
    pts0, pts1 = r.rand(20, 3).astype(np.float32), r.rand(15, 3).astype(
        np.float32)
    F0, F1 = r.randn(20, 8).astype(np.float32), r.randn(15, 8).astype(
        np.float32)
    nn01 = r.randint(0, 15, 20)
    idx0 = np.arange(20)
    ref = jdgr.inlier_input_features(feat_type, pts0, pts1, F0, F1, idx0,
                                     nn01)
    got = dgr.inlier_input_features(feat_type, pts0, pts1, F0, F1, idx0,
                                    nn01, device="cpu")
    assert got.shape[1] == dgr.inlier_input_feature_dim(feat_type, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)


# -- register() ---------------------------------------------------------------


@pytest.mark.parametrize("descriptor,use_icp", [("fcgf", False),
                                                ("fcgf", True),
                                                ("fpfh", False),
                                                ("fpfh", True)])
def test_register_matches_gmf_tpu(weights, pair, descriptor, use_icp):
    """The Procrustes + refinement path (the safeguard gate off)."""
    je, te = _engines(weights, descriptor=descriptor, use_icp=use_icp,
                      safeguard_min_weight=0.0, safeguard_min_frac=0.0)
    ref = je.register(*pair)
    got = te.register(*pair)
    np.testing.assert_array_equal(got["corres"][1], ref["corres"][1])
    np.testing.assert_array_equal(got["corres"][0], ref["corres"][0])
    assert got["used_safeguard"] == ref["used_safeguard"] is False
    np.testing.assert_allclose(got["weights"], ref["weights"], atol=1e-5)
    np.testing.assert_allclose(got["trans"], ref["trans"], atol=1e-4)


def test_safeguard_on_gmf_tpus_draw(weights, pair, monkeypatch):
    """The wsum gate trips (153 matches < 200) and the safeguard, fed
    gmf_tpu's own draw through ransac_from_indices, gives its T."""
    je, te = _engines(weights, use_icp=False)

    def jax_draw(n, seed=0):
        total = -(-te.config.safeguard_ransac_iters // 1024) * 1024
        idx = jax.random.randint(jax.random.PRNGKey(seed), (total, 4), 0, n)
        return torch.tensor(np.asarray(idx)).long()

    monkeypatch.setattr(te, "safeguard_indices", jax_draw)
    ref = je.register(*pair)
    got = te.register(*pair)
    assert got["used_safeguard"] and ref["used_safeguard"]
    np.testing.assert_allclose(got["trans"], ref["trans"], atol=1e-4)


def test_frag_cache_bit_identical_with_hits(weights, pair):
    _, plain = _engines(weights)
    cfg = dgr.DGRConfig(voxel_size=0.1, voxel_cap_granule=256,
                        corr_cap_granule=256, safeguard_ransac_iters=1024)
    fkw, ikw, _ = weights
    cached = dgr.DeepGlobalRegistration(
        {k: v.clone() for k, v in plain.fcgf.state_dict().items()},
        {k: v.clone() for k, v in plain.inlier.state_dict().items()}, cfg,
        fcgf_model=SparseResUNet2(**fkw), inlier_model=SparseResUNet2(**ikw),
        fcgf_dim=8, frag_cache_bytes=64 << 20, device="cpu")
    xyz0, xyz1, p, q = pair
    for a, b in (("A", "B"), ("B", "A"), ("A", "B")):
        frags = {"A": xyz0, "B": xyz1}
        want = plain.register(frags[a], frags[b], p, q)
        got = cached.register(frags[a], frags[b], p, q, cache_key0=a,
                              cache_key1=b)
        for key in ("trans", "weights"):
            np.testing.assert_array_equal(got[key], want[key])
        np.testing.assert_array_equal(got["corres"][1], want["corres"][1])
    assert cached.frag_cache_hits == 4
    cached.reset_frag_cache()
    assert cached.frag_cache_hits == 0


@pytest.mark.parametrize("descriptor", ["fcgf", "fpfh"])
def test_stage_methods_match_gmf_tpu_and_register(weights, pair, descriptor,
                                                  monkeypatch):
    """descriptor_features and inlier_prediction against gmf_tpu's (FCGF
    features and the logits within 1e-4 of their largest entry, the
    whole nets' bound; FPFH is ops/fpfh.py's, held to gmf_tpu by the
    FPFH tests below, whose bin flips this planar pair shows on many
    rows), and each equal in every bit to what the port's register()
    uses."""
    je, te = _engines(weights, descriptor=descriptor,
                      safeguard_min_weight=0.0, safeguard_min_frac=0.0)
    xyz0, xyz1, p, q = pair
    seen = {}
    solve = te._solve

    def spy(uniq_logits, inverse, *a, **k):
        seen["logits"] = uniq_logits[inverse].cpu().numpy()
        return solve(uniq_logits, inverse, *a, **k)

    monkeypatch.setattr(te, "_solve", spy)
    out = te.register(xyz0, xyz1, p, q)
    n = len(out["corres"][0])
    frags = []
    for xyz in (xyz0, xyz1):
        coords, sel = te.preprocess(xyz)
        pts = np.asarray(xyz)[sel]
        got = te.descriptor_features(coords, pts)
        ref = np.asarray(je.descriptor_features(coords, pts))
        used = te.prepare_fragment(xyz)["F"][:len(coords)].cpu().numpy()
        np.testing.assert_array_equal(got, used)
        assert got.shape == ref.shape
        if descriptor == "fcgf":
            np.testing.assert_allclose(got, ref, rtol=0,
                                       atol=1e-4 * np.abs(ref).max())
        else:  # gmf_tpu's FPFH and its bin flips: the FPFH tests below
            vs = te.config.voxel_size
            np.testing.assert_array_equal(got, fpfh.compute_fpfh(
                _t(pts), normal_radius=2 * vs, feature_radius=5 * vs).numpy())
        frags.append(coords)
    corr6d = np.concatenate([frags[0], frags[1][out["corres"][1]]], axis=1)
    got = te.inlier_prediction(corr6d, p, q)
    ref = np.asarray(je.inlier_prediction(corr6d, p, q))
    assert got.shape == (n,)
    np.testing.assert_array_equal(got, seen["logits"][:n])
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-4 * np.abs(ref).max())


def test_seed_fragment_fills_the_cache(weights, pair):
    """seed_fragment caches a fragment as gmf_tpu's does: the next
    register() of both keys hits twice, bit-identical to no cache."""
    fkw, ikw, (fv, iv) = weights
    _, plain = _engines(weights)
    kw = dict(voxel_size=0.1, voxel_cap_granule=256, corr_cap_granule=256,
              safeguard_ransac_iters=1024)
    cached = dgr.DeepGlobalRegistration(
        sparse_resunet_to_state_dict(fv), sparse_resunet_to_state_dict(iv),
        dgr.DGRConfig(**kw), fcgf_model=SparseResUNet2(**fkw),
        inlier_model=SparseResUNet2(**ikw), fcgf_dim=8,
        frag_cache_bytes=64 << 20, device="cpu")
    jcached = jdgr.DeepGlobalRegistration(
        fv, iv, jdgr.DGRConfig(**kw), fcgf_model=JaxNet(**fkw),
        inlier_model=JaxNet(**ikw), fcgf_dim=8, frag_cache_bytes=64 << 20)
    xyz0, xyz1, p, q = pair
    for eng in (cached, jcached):
        eng.seed_fragment(xyz0, "A")
        eng.seed_fragment(xyz1, "B")
        assert eng.frag_cache_hits == 0
    got = cached.register(xyz0, xyz1, p, q, cache_key0="A", cache_key1="B")
    jcached.register(xyz0, xyz1, p, q, cache_key0="A", cache_key1="B")
    assert cached.frag_cache_hits == jcached.frag_cache_hits == 2
    want = plain.register(xyz0, xyz1, p, q)
    for key in ("trans", "weights"):
        np.testing.assert_array_equal(got[key], want[key])


def test_engine_refuses_what_is_not_ported():
    """Every engine setting is ported now: bf16 nets
    (tests/test_torch_dgr_bf16.py), the device maps and the compacted
    convolution (tests/test_torch_device_maps.py) take no refusal; an
    unknown net type raises ValueError."""
    eng = dgr.DeepGlobalRegistration(
        config=dgr.DGRConfig(net_dtype="bfloat16"), device="cpu")
    assert eng.fcgf.dtype == eng.inlier.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="net_dtype"):
        dgr.DeepGlobalRegistration(
            config=dgr.DGRConfig(net_dtype="float16"), device="cpu")
    for kw in (dict(device_kernel_maps=True), dict(compact_inlier_conv=True)):
        dgr.DeepGlobalRegistration(config=dgr.DGRConfig(**kw), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            dgr.DeepGlobalRegistration()


# -- FPFH ---------------------------------------------------------------------


def _bin_flips_explained(pts, radius_n, radius_f):
    """Every SPFH bin that differs between the packages' own normals is on
    an edge (module docstring); returns (flips, pairs)."""
    flips, _, valid, _ = _spfh_flips(pts, radius_n, radius_f)
    return int(flips.sum()), int(valid.sum())


@jax.jit
def _jax_pair_bins(J, nj, ij):
    """gmf_tpu's SPFH bins of each pair, computed under jit as its jitted
    fpfh_features computes them (XLA may divide by a constant range as a
    product with its reciprocal, which moves a value on an edge into the
    other bin; eager ops would not show it)."""
    N, k = ij.shape
    f = jfpfh._pair_features(jnp.broadcast_to(J[:, None], (N, k, 3)),
                             jnp.broadcast_to(nj[:, None], (N, k, 3)),
                             J[ij], nj[ij])
    return [jnp.clip(((v - lo) / (hi - lo) * 11).astype(jnp.int32), 0, 10)
            for v, (lo, hi) in zip(f[:3], ((-1.0, 1.0), (-1.0, 1.0),
                                           (-jnp.pi, jnp.pi)))]


def _spfh_flips(pts, radius_n, radius_f):
    """The SPFH bins that differ between the packages' own normals, each
    asserted on an edge (module docstring): (flips [N], the count in each
    point's SPFH; the port's feature neighbourhoods idx [N, k], valid
    [N, k] and dist [N, k] as NumPy)."""
    P, J = _t(pts), jnp.asarray(pts)
    nt = fpfh.estimate_normals(P, radius_n, 30)
    nj = jfpfh.estimate_normals(J, radius_n, 30)
    np.testing.assert_allclose(nt.numpy(), np.asarray(nj), atol=1e-5)
    idx, valid, dist = fpfh._radius_knn(P, radius_f, 100)
    N, k = idx.shape
    ft = fpfh._pair_features(P[:, None].expand(N, k, 3),
                             nt[:, None].expand(N, k, 3), P[idx], nt[idx])
    ij = np.asarray(idx)
    bins_j = _jax_pair_bins(J, nj, jnp.asarray(ij))
    p2 = pts[ij] - pts[:, None]
    dh = p2 / np.linalg.norm(p2, axis=-1, keepdims=True)
    n1, n2 = np.asarray(nj)[:, None], np.asarray(nj)[ij]
    swap_tie = np.abs(np.abs((n1 * dh).sum(-1)) - np.abs((n2 * dh).sum(-1)))
    v = valid.numpy()
    flips = np.zeros(N, np.int64)
    for a, bb, (lo, hi) in zip(ft[:3], bins_j, fpfh.BIN_RANGES):
        a = a.numpy()
        pos = (a - lo) / (hi - lo) * 11
        ba = np.clip(pos.astype(np.int32), 0, 10)
        diff = (ba != np.asarray(bb)) & v
        on_edge = np.abs(pos - np.round(pos)) < 1e-4 * 11 / (hi - lo)
        branch_cut = (hi == math.pi) & (np.abs(np.abs(a) - math.pi) < 1e-4)
        assert np.all((on_edge | branch_cut | (swap_tie < 1e-5))[diff])
        flips += diff.sum(1)
    return flips, ij, v, dist.numpy()


def test_fpfh_against_gmf_tpu_and_golden():
    """gmf_tpu's golden input (tests/test_golden.py:74-79)."""
    rng = np.random.RandomState(51)
    pts = rng.rand(80, 3).astype(np.float32)
    got = fpfh.compute_fpfh(_t(pts), normal_radius=0.3, feature_radius=0.6)
    golden = np.load(GOLDEN_FPFH)["value"]
    assert got.shape == golden.shape
    # on gmf_tpu's normals the features agree to 1e-5 of their scale
    nj = jfpfh.estimate_normals(jnp.asarray(pts), 0.3, 30)
    f_t = fpfh.fpfh_features(_t(pts), _t(nj), 0.6, 100).numpy()
    f_j = np.asarray(jfpfh.fpfh_features(jnp.asarray(pts), nj, 0.6, 100))
    np.testing.assert_allclose(f_t, f_j, atol=1e-5 * np.abs(f_j).max())
    # on its own normals only edge values change bin, a few in a thousand
    flips, pairs = _bin_flips_explained(pts, 0.3, 0.6)
    assert flips <= 0.005 * pairs, (flips, pairs)
    # which moves each unit row by 100/79 per flipped count at most
    assert np.abs(got.numpy() - golden).max() < 0.05


def test_fpfh_surface_and_mask(monkeypatch):
    """A DGR-like surface at voxel 0.05 with 2x/5x radii, and the mask.
    The masked neighbourhoods: the same indices and validity, distances
    within 1e-5 (both expand |a|^2 - 2ab + |b|^2, whose last bits differ,
    and 1/dist of a close pair amplifies that); on gmf_tpu's normals and
    neighbourhoods the features within 1e-5 of their scale."""
    p = dgr_loader.make_dgr_pair(np.random.RandomState(4), n_points=700,
                                 voxel_size=0.05, surface=True)["pcd0"]
    flips, pairs = _bin_flips_explained(p, 0.1, 0.25)
    assert flips <= 0.005 * pairs, (flips, pairs)
    mask = (np.arange(len(p)) < len(p) - 30).astype(np.float32)
    P, J, M, JM = _t(p), jnp.asarray(p), _t(mask), jnp.asarray(mask)
    knn_j = [np.asarray(a) for a in jfpfh._radius_knn(J, 0.25, 100, JM)]
    knn_t = [a.numpy() for a in fpfh._radius_knn(P, 0.25, 100, M)]
    np.testing.assert_array_equal(knn_t[0], knn_j[0])
    np.testing.assert_array_equal(knn_t[1], knn_j[1])
    np.testing.assert_allclose(knn_t[2], knn_j[2], atol=1e-5)
    nj = jfpfh.estimate_normals(J, 0.1, 30, JM)
    f_j = np.asarray(jfpfh.fpfh_features(J, nj, 0.25, 100, mask=JM))
    monkeypatch.setattr(fpfh, "_radius_knn", lambda *a, **k: (
        torch.tensor(knn_j[0]).long(), _t(knn_j[1]), _t(knn_j[2])))
    f_t = fpfh.fpfh_features(P, _t(nj), 0.25, 100, mask=M).numpy()
    np.testing.assert_allclose(f_t, f_j, atol=1e-5 * np.abs(f_j).max())
    assert not f_t[len(p) - 30:].any()


# -- loaders, PLY, checkpoints ----------------------------------------------


def test_dgr_pair_and_matching_helpers():
    kw = dict(n_points=400, voxel_size=0.05, surface=True, outlier_bias=0.3,
              outlier_scatter=0.1)
    got = dgr_loader.make_dgr_pair(np.random.RandomState(9), **kw)
    ref = jdl.make_dgr_pair(np.random.RandomState(9), **kw)
    assert got.keys() == ref.keys()
    for key in got:
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
    args = (got["pcd0"], got["pcd1"], got["T_gt"], 0.1)
    assert dgr_loader.compute_overlap_ratio(*args) == \
        jdl.compute_overlap_ratio(*args)
    pos = got["correspondences"]
    pred = np.stack([np.arange(len(got["pcd0"])),
                     np.random.RandomState(1).randint(0, len(got["pcd1"]),
                                                      len(got["pcd0"]))], 1)
    pred[:20] = pos[:20]
    np.testing.assert_array_equal(
        dgr_loader.find_correct_correspondence(pos, pred, 10 ** 6),
        jdl.find_correct_correspondence(pos, pred, 10 ** 6))
    F = np.random.RandomState(2).randn(len(got["pcd0"]), 8)
    F1 = np.random.RandomState(3).randn(len(got["pcd1"]), 8)
    assert dgr_loader.feature_hit_ratio(
        F, F1, got["pcd0"], got["pcd1"], got["T_gt"], 0.1, device="cpu") \
        == jdl.feature_hit_ratio(F, F1, got["pcd0"], got["pcd1"],
                                 got["T_gt"], 0.1)


def test_ply_roundtrip_and_gmf_tpu_reads_it(tmp_path):
    from gmf_tpu.data.ply import read_ply as jax_read_ply

    xyz = np.random.RandomState(0).rand(37, 3).astype(np.float32)
    for ascii_fmt in (False, True):
        path = str(tmp_path / f"c{int(ascii_fmt)}.ply")
        write_ply(path, xyz, ascii_fmt=ascii_fmt)
        np.testing.assert_allclose(read_ply(path)["xyz"], xyz, rtol=1e-6)
        np.testing.assert_array_equal(read_ply(path)["xyz"],
                                      jax_read_ply(path)["xyz"])


# -- the command line -------------------------------------------------------


def _png(path, rng, hw=(24, 32)):
    import matplotlib.image as mpimg

    mpimg.imsave(path, (rng.rand(*hw, 3) * 255).astype(np.uint8))


@pytest.fixture(scope="module")
def dgr_tree(tmp_path_factory, weights):
    """A 3DMatch scene of two fragments (two pairs in gt.log), a KITTI
    sequence of three frames (one pair >= 10 m), and the tiny CLI's
    checkpoints: gmf_tpu's (flax) and the port's (bridged)."""
    root = tmp_path_factory.mktemp("dgr")
    rng = np.random.RandomState(7)
    scene = SCENE
    seq = root / "3dmatch" / scene / "seq-01"
    os.makedirs(seq)
    xy = rng.rand(500, 2) * 2
    world = np.concatenate([xy, 0.2 * np.sin(3 * xy[:, :1]) * np.cos(
        2 * xy[:, 1:])], 1).astype(np.float32)
    R, t = _rot(0.3), np.array([0.2, -0.1, 0.1], np.float32)
    write_ply(str(seq / "cloud_bin_0.ply"), world)
    write_ply(str(seq / "cloud_bin_1.ply"), world @ R.T + t)
    for i in range(2):
        _png(str(seq / f"cloud_bin_{i}_0.png"), rng)
    T = np.eye(4)
    T[:3, :3], T[:3, 3] = R, t
    with open(root / "3dmatch" / scene / "gt.log", "w") as f:
        for (i, j), Tij in (((0, 1), np.linalg.inv(T)), ((1, 0), T)):
            f.write(f"{i} {j} 2\n")
            for row in Tij:
                f.write(" ".join(f"{v:.8f}" for v in row) + "\n")

    kseq = root / "kitti" / "sequences" / "08"
    (kseq / "velodyne").mkdir(parents=True)
    (kseq / "image_2").mkdir()
    (root / "kitti" / "poses").mkdir()
    ground = rng.rand(1500, 2) * 40 - 20
    base = np.concatenate([ground, 1.5 * np.sin(ground[:, :1] / 3) * np.cos(
        ground[:, 1:] / 4)], 1).astype(np.float32)
    poses = []
    for f in range(3):
        P = np.eye(4)
        P[:3, 3] = [6.0 * f, 0, 0]
        poses.append(P[:3, :4].reshape(-1))
        pts = base - np.array([6.0 * f, 0, 0], np.float32)
        np.concatenate([pts, np.ones((len(pts), 1), np.float32)], 1).astype(
            np.float32).tofile(kseq / "velodyne" / f"{f:06d}.bin")
        _png(str(kseq / "image_2" / f"{f:06d}.png"), rng)
    np.savetxt(root / "kitti" / "poses" / "08.txt", np.stack(poses))
    with open(kseq / "calib.txt", "w") as f:
        f.write("Tr: " + " ".join(f"{v:.6f}" for v in np.eye(4)[:3].ravel())
                + "\n")

    from gmf_tpu.utils.checkpoint import save_checkpoint as jax_save

    fkw, ikw = _nets(3)  # the CLI's --tiny nets (conv1 3)
    fv, iv = _jax_vars(fkw, ikw)
    ckpt = {}
    for name, v in (("fcgf", fv), ("inlier", iv)):
        ckpt[f"jax_{name}"] = str(root / f"jax_{name}")
        jax_save(ckpt[f"jax_{name}"], dict(v))
        ckpt[name] = save_checkpoint(str(root / f"torch_{name}"),
                                     sparse_resunet_to_state_dict(v))
    return root, ckpt


def _run_jax_cli(monkeypatch, argv):
    from gmf_tpu.eval import test_dgr as jax_cli

    monkeypatch.setattr(sys, "argv", ["test_dgr"] + argv)
    jax_cli.main()


def _cli_args(root, ckpt, dataset, out, prefix=""):
    data = str(root / ("kitti" if dataset == "kitti" else "3dmatch"))
    scenes = ["08"] if dataset == "kitti" else [SCENE]
    return ["--root", data, "--dataset", dataset, "--scenes", *scenes,
            "--fcgf-checkpoint", ckpt[prefix + "fcgf"],
            "--inlier-checkpoint", ckpt[prefix + "inlier"],
            "--tiny", "--out", str(out)]


@pytest.mark.parametrize("dataset,extra", [
    ("3dmatch", ["--voxel", "0.1", "--safeguard-min-weight", "0"]),
    ("3dmatch", ["--voxel", "0.1", "--use-icp"]),
    ("kitti", ["--safeguard-min-weight", "0", "--use-icp"]),
])
def test_cli_matches_gmf_tpu(dgr_tree, monkeypatch, tmp_path, dataset,
                             extra):
    """Both CLIs, --descriptor fpfh (the FCGF checkpoint is unused), on
    the same trees: rows [success, rre, rte, scene, used_safeguard]. The
    success and safeguard flags equal. Off the safeguard, rre within 0.05
    deg and rte within 1e-3 m: an FPFH entry on a bin's edge may flip
    (bounded in the FPFH tests), which moves a few 1-NN matches and so
    the Procrustes solution (measured: 0.019 deg on one pair of the
    3DMatch fixture, 4e-5 deg on the other). Through the safeguard the
    packages draw their hypotheses apart, so only the flags compare."""
    from gmf_tpu_torch.eval import test_dgr

    root, ckpt = dgr_tree
    extra = extra + ["--descriptor", "fpfh"]
    if dataset == "kitti":
        # gmf_tpu caches the ICP-refined GT beside the data: give each
        # package its own cache by running it on its own copy
        import shutil

        for who in ("jax", "torch"):
            shutil.copytree(root / "kitti", tmp_path / who / "kitti",
                            ignore=shutil.ignore_patterns("icp_cache"))
        roots = {w: tmp_path / w for w in ("jax", "torch")}
    else:
        roots = {"jax": root, "torch": root}
    _run_jax_cli(monkeypatch, _cli_args(roots["jax"], ckpt, dataset,
                                        tmp_path / "jax_out", "jax_")
                 + extra)
    ref = np.load(tmp_path / "jax_out" / "dgr_stats.npy")
    got = test_dgr.main(_cli_args(roots["torch"], ckpt, dataset,
                                  tmp_path / "out") + extra + ["--cpu"])
    np.testing.assert_array_equal(
        got, np.load(tmp_path / "out" / "dgr_stats.npy"))
    assert got.shape == ref.shape == (2 if dataset == "3dmatch" else 1, 5)
    np.testing.assert_array_equal(got[:, [0, 3, 4]], ref[:, [0, 3, 4]])
    if "--use-icp" not in extra or dataset == "kitti":
        np.testing.assert_allclose(got[:, 1], ref[:, 1], atol=0.05)
        np.testing.assert_allclose(got[:, 2], ref[:, 2], atol=1e-3)


def test_cli_fcgf_shards_overlap_and_refusals(dgr_tree, tmp_path, caplog):
    """The port's own --tiny FCGF run: threaded == serial, two strided
    shards merge into the serial rows, the stale-shard checks, and
    --srcdense-rowmode-min: logged as changing nothing (the rows equal
    the serial run's), a value under 1 refused by name."""
    from gmf_tpu_torch.eval import test_dgr

    root, ckpt = dgr_tree

    def args(out, *more):
        # off the safeguard: its 80,000 hypotheses are not what is tested
        return _cli_args(root, ckpt, "3dmatch", out) + [
            "--voxel", "0.1", "--safeguard-min-weight", "0", "--cpu", *more]

    with caplog.at_level(logging.INFO):
        serial = test_dgr.main(args(tmp_path / "ser"))
    assert serial.shape == (2, 5) and np.isfinite(serial).all()
    assert "recall=" in caplog.text and "frag-cache hits 2/4" in caplog.text
    ovl = test_dgr.main(args(tmp_path / "ovl", "--overlap", "2",
                             "--workers", "2"))
    np.testing.assert_array_equal(ovl, serial)
    out = tmp_path / "sh"
    for i in range(2):
        rows = test_dgr.main(args(out, "--shard-index", str(i),
                                  "--shard-count", "2"))
        np.testing.assert_array_equal(rows, serial[i::2])
    merged = test_dgr.main(args(out, "--merge-shards"))
    np.testing.assert_array_equal(np.sort(merged, 0), np.sort(serial, 0))
    np.save(out / "dgr_stats_shard0of3.npy", serial[:1])
    with pytest.raises(SystemExit, match="mixed shard counts"):
        test_dgr.main(args(out, "--merge-shards"))
    caplog.clear()
    with caplog.at_level(logging.INFO):
        rows = test_dgr.main(args(tmp_path / "rm", "--srcdense-rowmode-min",
                                  "2"))
    np.testing.assert_array_equal(rows, serial)
    assert "--srcdense-rowmode-min 2: no effect" in caplog.text
    with pytest.raises(SystemExit, match="srcdense-rowmode-min must be"):
        test_dgr.main(args(out, "--srcdense-rowmode-min", "0"))
