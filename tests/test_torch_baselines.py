"""gmf_tpu_torch's classical baselines (eval/baselines.py, the native
PMC and GC-RANSAC shims, the baseline_eval command line) against
gmf_tpu's on the same inputs (CPU, f32).

Pairs are tests/test_baselines.py's (a known rotation and translation,
half the correspondences outliers) and tests/torch_eval_fixtures.py's
3DMatch tree. Tolerances:
- SM: T within 1e-4; labels equal where the eigenvector's entries do not
  tie at the top-10% cut (the two packages' power iterations differ in
  the last bits);
- PMC: the edge list and the clique equal; T within 1e-5;
- RANSAC on gmf_tpu's own draws: inliers equal, T within 1e-5;
- GC-RANSAC: the port's library against gmf_tpu's (the same source,
  built apart): pose within 1e-5, masks equal;
- recovering T: tests/test_baselines.py's tolerances;
- baseline_eval: each method's *_stats.npy within
  tests/test_torch_eval.py::_assert_stats_close's tolerances.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_eval_fixtures as fx
from gmf_tpu.eval import baseline_eval as jax_baseline_eval
from gmf_tpu.eval import baselines as jb
from gmf_tpu.utils import gcransac as jax_gcransac
from gmf_tpu_torch.eval import baseline_eval, baselines
from gmf_tpu_torch.geometry.ransac import ransac_from_indices
from gmf_tpu_torch.utils import gcransac, max_clique, native
from test_baselines import make_pair
from test_torch_eval import _assert_stats_close

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def pair():
    return make_pair(np.random.RandomState(51))


def _args(p):
    return p["corr_pos"], p["src_keypts"], p["tgt_keypts"], 0.10


def test_sm_matches_gmf_tpu(pair):
    from gmf_tpu.geometry.spectral import leading_eigenvector_fixed

    p, _ = pair
    T_ref, lab_ref = jb.sm_register(*_args(p))
    T, lab = baselines.sm_register(*_args(p), device="cpu")
    np.testing.assert_allclose(T, T_ref, rtol=0, atol=1e-4)
    # gmf_tpu's lengths (its [N, N, 6] differences) and eigenvector
    corr = jnp.asarray(p["corr_pos"])
    diff = corr[:, None, :] - corr[None, :, :]
    d = (jnp.linalg.norm(diff[:, :, 0:3], axis=-1)
         - jnp.linalg.norm(diff[:, :, 3:6], axis=-1))
    got_d = baselines.length_consistency(torch.from_numpy(p["corr_pos"]),
                                         row_block=64)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(d), rtol=0,
                               atol=1e-6)
    M = jnp.maximum(0.0, 4.5 - d ** 2 / (2 * (0.10 / 3) ** 2))
    M = M * (1.0 - jnp.eye(M.shape[0]))
    eig = np.asarray(leading_eigenvector_fixed(M[None], num_iters=10)[0])
    cut = np.sort(eig)[::-1][int(lab.sum()) - 1]
    apart = lab != lab_ref
    assert lab.sum() == lab_ref.sum() == 20
    assert np.all(np.abs(eig[apart] - cut) <= 1e-5 * eig.max())


def test_pmc_edges_and_clique_match_gmf_tpu(pair):
    p, _ = pair
    corr = p["corr_pos"]
    ei, ej = baselines.consistency_edges(corr, 0.10)
    # gmf_tpu's construction (gmf_tpu/eval/baselines.py:113-122)
    s, t = corr[:, 0:3], corr[:, 3:6]
    ok = np.abs(((s[:, None] - s[None]) ** 2).sum(-1)
                - ((t[:, None] - t[None]) ** 2).sum(-1)) < 0.10
    np.fill_diagonal(ok, False)
    want_i, want_j = np.where(np.triu(ok, 1))
    np.testing.assert_array_equal(ei, want_i)
    np.testing.assert_array_equal(ej, want_j)
    T_ref, lab_ref = jb.pmc_register(*_args(p))
    T, lab = baselines.pmc_register(*_args(p), device="cpu")
    np.testing.assert_array_equal(lab, lab_ref)
    np.testing.assert_allclose(T, T_ref, rtol=0, atol=1e-5)
    # the plain greedy search finds the same clique on this graph
    adj = np.zeros((len(corr), len(corr)), bool)
    adj[ei, ej] = adj[ej, ei] = True
    np.testing.assert_array_equal(max_clique.max_clique_python(adj),
                                  np.sort(max_clique.pmc(ei, ej, len(corr),
                                                         len(ei))))


def test_ransac_on_jax_draws(pair):
    """gmf_tpu's ransac_register and its draw fed to the port."""
    p, _ = pair
    T_ref, inl_ref = jb.ransac_register(p["src_keypts"], p["tgt_keypts"],
                                        0.10, max_iteration=2048)
    idx = jax.random.randint(jax.random.PRNGKey(0), (2048, 3), 0,
                             len(p["src_keypts"]))
    T, inl, _ = ransac_from_indices(
        torch.from_numpy(p["src_keypts"]), torch.from_numpy(p["tgt_keypts"]),
        torch.from_numpy(np.array(idx)).long(), 0.10)
    np.testing.assert_array_equal(inl.numpy().astype(np.float32), inl_ref)
    np.testing.assert_allclose(T.numpy(), T_ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("n,ratio,seed", [(200, 0.5, 0), (600, 0.25, 3)])
def test_gcransac_library_matches_gmf_tpu(n, ratio, seed):
    p, _ = make_pair(np.random.RandomState(seed), N=n, inlier_ratio=ratio)
    kw = dict(threshold=0.05, max_iters=2000, seed=seed)
    pose_ref, mask_ref = jax_gcransac.gcransac_rigid(
        p["src_keypts"], p["tgt_keypts"], **kw)
    pose, mask = gcransac.gcransac_rigid(p["src_keypts"], p["tgt_keypts"],
                                         **kw)
    np.testing.assert_array_equal(mask, mask_ref)
    np.testing.assert_allclose(pose, pose_ref, rtol=0, atol=1e-5)
    assert mask.sum() >= 0.2 * n
    # the port's library is its own build, under ops/build/
    assert gcransac.library_path().parent == native.BUILD_DIR


def test_gcransac_native_available(tmp_path, monkeypatch):
    """True here as gmf_tpu's; False, not an error, when the source does
    not build."""
    assert gcransac.native_available() is jax_gcransac.native_available()
    assert gcransac.native_available() is True
    bad = tmp_path / "gcransac_rigid.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(gcransac, "SOURCE", bad)
    monkeypatch.setattr(gcransac, "_LIB", None)
    assert gcransac.native_available() is False


@pytest.mark.parametrize("method,atol_r,atol_t", [
    ("SM", 0.05, 0.05), ("PMC", 0.02, 0.03), ("RANSAC", 0.02, 0.03),
    ("GCRANSAC", 0.02, 0.03)])
def test_baselines_recover_the_transform(pair, method, atol_r, atol_t):
    p, T_gt = pair
    fn = baselines.make_baseline_register_fn(
        method, inlier_threshold=0.10, max_iteration=2048, device="cpu")
    trans, labels = fn(p)
    np.testing.assert_allclose(trans[:3, :3], T_gt[:3, :3], atol=atol_r)
    np.testing.assert_allclose(trans[:3, 3], T_gt[:3, 3], atol=atol_t)
    assert labels.sum() >= 3 and labels.shape == (len(p["corr_pos"]),)


def test_unknown_method_and_failed_build_raise(tmp_path, monkeypatch):
    with pytest.raises(ValueError, match="unknown baseline"):
        baselines.make_baseline_register_fn("TEASER", device="cpu")
    bad = tmp_path / "max_clique.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(max_clique, "SOURCE", bad)
    monkeypatch.setattr(max_clique, "_LIB", None)
    with pytest.raises(RuntimeError, match="maximum-clique solver.*failed"):
        baselines.make_baseline_register_fn("PMC", device="cpu")
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    if not baselines._pygcransac_available():
        with pytest.raises(baselines.BaselineUnavailable):
            baselines.make_baseline_register_fn("GCRANSAC", device="cpu")


def _jax_cli(argv):
    saved = sys.argv
    sys.argv = ["baseline_eval"] + argv
    try:
        jax_baseline_eval.main()
    finally:
        sys.argv = saved


def test_baseline_eval_matches_gmf_tpu(tmp_path, caplog):
    tree = fx.write_3dmatch_tree(str(tmp_path / "tree"))
    argv = ["--root", tree["root"], "--scenes", fx.SCENE, "--methods", "SM",
            "PMC"]
    _jax_cli(argv + ["--out", str(tmp_path / "jax")])
    got = baseline_eval.main(argv + ["--out", str(tmp_path / "port"),
                                     "--cpu"])
    assert sorted(got) == ["PMC", "SM"]
    for method in ("SM", "PMC"):
        path = os.path.join(tmp_path, "port", f"{method}_stats.npy")
        stats = np.load(path)
        np.testing.assert_array_equal(stats, got[method]["all_stats"])
        _assert_stats_close(stats, np.load(
            os.path.join(tmp_path, "jax", f"{method}_stats.npy")))
        assert stats.shape == (len(fx.PAIRS), 12)
    assert "SKIPPED" not in caplog.text
