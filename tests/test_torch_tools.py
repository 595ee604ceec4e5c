"""gmf_tpu_torch's tools and utilities (tools/{precompute_descriptors,
build_kitti_pairs,analyze_stats,numerics_study}.py, data/camera.py,
utils/{timer,logging_utils,profiling}.py) vs gmf_tpu's on the same
inputs (CPU).

Tolerances, each stated beside its assertion:
- NumPy and plain-Python modules (camera, analyze_stats, the timers, the
  metrics stream): equal;
- FPFH (precompute_descriptors, build_kitti_pairs): the voxelized points
  equal; every SPFH bin that differs between the packages lies on a
  bin's edge, at atan2's cut or on the source-swap tie, at most 0.5% of
  the pairs (tests/test_torch_dgr.py's ``_spfh_flips``); the written unit
  rows against gmf_tpu's, row by row, within 1e-5 plus what those flips
  and the last bits of the distances can move them (``_assert_fpfh_rows``);
- FCGF through the bridged weights (narrow nets, conv1 7 for 3DMatch and
  5 for KITTI): within 1e-5 of gmf_tpu's features on its host maps;
- build_kitti_pairs: the npz keys, clouds and images equal; gt_trans
  (each package's own ICP refinement) within 1e-5.
"""

import json
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gmf_tpu.data import camera as jcamera
from gmf_tpu.ops import fpfh as jfpfh
from gmf_tpu.sparse.kernel_map import build_pyramid as jax_build_pyramid
from gmf_tpu.sparse.resunet import SparseResUNet2 as JaxNet
from gmf_tpu.sparse.resunet import pyramid_to_arrays as jax_arrays
from gmf_tpu.tools import analyze_stats as janalyze
from gmf_tpu.tools import precompute_descriptors as jprecompute
from gmf_tpu.utils import logging_utils as jlogging
from gmf_tpu.utils import timer as jtimer
from gmf_tpu_torch.data import camera
from gmf_tpu_torch.data.dgr_loader import make_dgr_pair
from gmf_tpu_torch.data.ply import write_ply
from gmf_tpu_torch.ops import fpfh
from gmf_tpu_torch.sparse.resunet import SparseResUNet2
from gmf_tpu_torch.sparse.voxelize import sparse_quantize
from gmf_tpu_torch.tools import (analyze_stats, build_kitti_pairs,
                                 numerics_study, precompute_descriptors)
from gmf_tpu_torch.utils import logging_utils, profiling, timer
from gmf_tpu_torch.utils.bridge import sparse_resunet_to_state_dict
from gmf_tpu_torch.utils.checkpoint import save_checkpoint
from test_torch_dgr import NARROW, _spfh_flips

torch.set_num_threads(2)
CPU = "cpu"


def _run_jax_main(module, argv):
    saved = sys.argv
    sys.argv = [module.__name__] + argv
    try:
        module.main()
    finally:
        sys.argv = saved


# -- camera, timers, metrics --------------------------------------------------

def test_camera_functions_match_gmf_tpu():
    rng = np.random.RandomState(0)
    K = np.array([[100.0, 0, 80], [0, 100.0, 60], [0, 0, 1]], np.float32)
    pts = rng.rand(300, 3).astype(np.float32) * 2 - 1
    pts[:, 2] += 1.5
    w2cs = []
    for i in range(3):
        T = np.eye(4)
        T[:3, 3] = [0.5 * i, -0.2 * i, 0.3 * (i - 1)]
        w2cs.append(T)
    depth = np.full((120, 160), 2.0, np.float32)
    image = rng.rand(120, 160, 3).astype(np.float32)
    for w2c in [None] + w2cs:
        for a, b in zip(camera.project_points(pts, K, w2c),
                        jcamera.project_points(pts, K, w2c)):
            np.testing.assert_array_equal(a, b)
    for w2c in w2cs:
        for d in (None, depth):
            np.testing.assert_array_equal(
                camera.visibility_mask(pts, K, w2c, (120, 160), depth=d),
                jcamera.visibility_mask(pts, K, w2c, (120, 160), depth=d))
        for a, b in zip(camera.colors_for_points(pts, image, K, w2c),
                        jcamera.colors_for_points(pts, image, K, w2c)):
            np.testing.assert_array_equal(a, b)
    assert camera.best_frame_for_cloud(pts, K, w2cs, (120, 160)) == \
        jcamera.best_frame_for_cloud(pts, K, w2cs, (120, 160))


def test_timer_and_meter_match_gmf_tpu():
    vals = np.random.RandomState(1).rand(7)
    a, b = timer.AverageMeter(), jtimer.AverageMeter()
    for i, v in enumerate(vals):
        a.update(float(v), n=i % 3 + 1)
        b.update(float(v), n=i % 3 + 1)
    assert vars(a) == vars(b)
    t = timer.Timer()
    for _ in range(3):
        t.tic()
        t.toc()
    assert t.calls == 3 and t.avg == t.total_time / 3 >= 0.0


def test_metrics_logger_writes_what_gmf_tpu_writes(tmp_path):
    """The JSONL rows equal but for their time stamps."""
    rows = {}
    for tag, mod in (("port", logging_utils), ("jax", jlogging)):
        log = mod.MetricsLogger(str(tmp_path / tag), use_tensorboard=False)
        log.log({"loss": 0.5, "acc": 1, "name": "x"}, step=3, prefix="train")
        log.log({"loss": np.float32(0.25)}, step=4)
        log.close()
        with open(tmp_path / tag / "metrics.jsonl") as f:
            rows[tag] = [json.loads(r) for r in f]
        for r in rows[tag]:
            assert r.pop("time") > 0
    assert rows["port"] == rows["jax"]
    assert rows["port"][0] == {"step": 3, "prefix": "train", "loss": 0.5,
                               "acc": 1.0}


def test_profiling_trace_on_the_cpu(tmp_path):
    """A Chrome trace in log_dir naming the annotation and the regions
    inside it; no device memory on the CPU."""
    with profiling.trace(str(tmp_path), annotate="outer") as prof:
        with profiling.annotation("inner"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    files = os.listdir(tmp_path)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(tmp_path / files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"outer", "inner"} <= names
    assert any(e.key == "inner" for e in prof.key_averages())
    assert profiling.device_memory_stats(CPU) == {}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            profiling.device_memory_stats()


# -- analyze_stats ------------------------------------------------------------

def _stats12(rng, n=40):
    s = rng.rand(n, 12)
    s[:, 0] = rng.rand(n) < 0.7
    s[:, 11] = rng.randint(0, 3, n)
    return s


def _results(rng, m=3, n=60):
    stats = rng.rand(m, n, 5)
    stats[:, :, 1] *= 0.5
    stats[:, :, 2] *= 20
    stats[:, :, 4] = rng.randint(0, 4, n)
    return np.array(["RANSAC", "DGR", "Ours"]), stats


def test_analyze_stats_matches_gmf_tpu(tmp_path, capsys):
    rng = np.random.RandomState(2)
    s12 = _stats12(rng)
    assert analyze_stats.summarize(s12) == janalyze.summarize(s12)
    names, stats = _results(rng)
    for rte, rre in ((0.3, 15.0), (0.1, 5.0), (np.inf, 10.0)):
        np.testing.assert_array_equal(
            analyze_stats.analyze_by_pair(stats, rte, rre),
            janalyze.analyze_by_pair(stats, rte, rre))
    scenes = np.unique(stats[0, :, 4]).astype(int)
    np.testing.assert_array_equal(
        analyze_stats.analyze_by_scene(stats, scenes),
        janalyze.analyze_by_scene(stats, scenes))
    for a, b in zip(
            analyze_stats.precision_recall_curves(
                stats, np.arange(0.05, 0.35, 0.05), np.arange(1, 16, 2)),
            janalyze.precision_recall_curves(
                stats, np.arange(0.05, 0.35, 0.05), np.arange(1, 16, 2))):
        np.testing.assert_array_equal(a, b)
    assert analyze_stats.summarize_methods(names, stats) == \
        janalyze.summarize_methods(names, stats)
    np.save(tmp_path / "stats.npy", s12)
    np.savez(tmp_path / "results.npz", names=names, stats=stats)
    argv = [str(tmp_path / "stats.npy"), str(tmp_path / "results.npz"),
            "--rte", "0.2"]
    capsys.readouterr()
    analyze_stats.main(argv)
    got = capsys.readouterr().out
    _run_jax_main(janalyze, argv)
    assert got == capsys.readouterr().out and "scene recalls" in got


# -- descriptors --------------------------------------------------------------

def _fcgf(conv1):
    """gmf_tpu's narrow FCGF initialisation and the port's net bridged
    from it."""
    kw = dict(in_channels=1, out_channels=8, dim=3, conv1_kernel_size=conv1,
              normalize_feature=True, **NARROW)
    c = np.unique(np.random.RandomState(5).randint(0, 10, (80, 3)).astype(
        np.int32), axis=0)
    a = jax_arrays(jax_build_pyramid(c, 4, conv1, granule=256))
    v = jax.jit(JaxNet(**kw).init)(jax.random.PRNGKey(conv1),
                                   jnp.ones((a["mask_0"].shape[0], 1)), a)
    v = jax.tree.map(np.asarray, v)
    net = SparseResUNet2(**kw)
    net.load_state_dict(sparse_resunet_to_state_dict(v))
    return JaxNet(**kw), v, net.eval()


def _jax_fcgf(model, variables, coords, conv1):
    """gmf_tpu's FCGF of voxel coords on its host maps, as its tools
    compute it (``build_pyramid(coords, 4, conv1, granule=4096)`` and the
    net's apply, here jitted)."""
    pyr = jax_build_pyramid(coords, 4, conv1_kernel_size=conv1, granule=4096)
    out = jax.jit(model.apply)(variables, jnp.ones((pyr.levels[0].cap, 1)),
                               jax_arrays(pyr))
    return np.asarray(out)[:len(coords)]


@pytest.fixture(scope="module")
def threedmatch_tree(tmp_path_factory):
    """Two surface fragments (tests/test_torch_dgr.py's FPFH surface) as
    PLY clouds in a 3DMatch sequence."""
    root = tmp_path_factory.mktemp("clouds")
    seq = root / "7-scenes-redkitchen" / "seq-01"
    os.makedirs(seq)
    p = make_dgr_pair(np.random.RandomState(4), n_points=700,
                      voxel_size=0.05, surface=True)
    for i, key in enumerate(("pcd0", "pcd1")):
        write_ply(str(seq / f"cloud_bin_{i}.ply"), p[key])
    return root


def _assert_fpfh_rows(got, ref, pts, radius_n, radius_f):
    """The written FPFH rows (unit L2) against gmf_tpu's, row by row.
    FPFH(p) = SPFH(p) + sum_q SPFH(q) / (c_p d(p, q)) over p's c_p
    neighbours. Two things move it between the packages:
    - a flipped bin in SPFH(q) (``_spfh_flips``: on an edge, at most 0.5%
      of the pairs) moves one of q's c_q counts, 200 / c_q in L1;
    - d(p, q) differs in its last bits (both expand |a|^2 - 2ab + |b|^2),
      which 1 / d of a close pair amplifies: sum_q SPFH(q) d(1 / d) / c_p.
    Every entry is >= 0 and each of SPFH(p)'s three histograms sums to
    100, so |FPFH(p)|_2 >= 100 sqrt(3 / 11), and the unit rows lie within
    2 |dFPFH(p)| / (100 sqrt(3 / 11)) + 1e-5 of each other. Returns (rows
    with a flip in reach, rows)."""
    flips, idx, valid, dist = _spfh_flips(pts, radius_n, radius_f)
    assert flips.sum() <= 0.005 * valid.sum(), (flips.sum(), valid.sum())
    cnt = np.maximum(valid.sum(1), 1)
    d_spfh = 200.0 * flips / cnt
    d_flips = d_spfh + np.where(valid, d_spfh[idx] / np.maximum(dist, 1e-6),
                                0.0).sum(1) / cnt
    P = torch.as_tensor(pts)
    spfh = fpfh._spfh(P, fpfh.estimate_normals(P, radius_n, 30),
                      torch.as_tensor(idx), torch.as_tensor(valid)).numpy()
    dist_j = np.asarray(jfpfh._radius_knn(jnp.asarray(pts), radius_f,
                                          100)[2])
    d_inv = np.where(valid, 1 / np.maximum(dist, 1e-6)
                     - 1 / np.maximum(dist_j, 1e-6), 0.0)
    d_dist = np.linalg.norm(np.einsum("nk,nkc->nc", d_inv, spfh[idx]),
                            axis=1) / cnt
    bound = 2 * (d_flips + d_dist) / (100 * np.sqrt(3 / 11)) + 1e-5
    gap = np.linalg.norm(got.astype(np.float64) - ref, axis=1)
    assert np.all(gap <= bound), (gap - bound).max()
    return int((d_flips > 0).sum()), len(gap)


def test_precompute_fpfh_matches_gmf_tpu(threedmatch_tree, tmp_path):
    """Both command lines on copies of one tree (module docstring)."""
    for tag in ("port", "jax"):
        shutil.copytree(threedmatch_tree, tmp_path / tag)
    written = precompute_descriptors.main(
        ["--root", str(tmp_path / "port"), "--voxel", "0.05", "--cpu"])
    _run_jax_main(jprecompute, ["--root", str(tmp_path / "jax"),
                                "--voxel", "0.05"])
    assert len(written) == 2
    for path in written:
        got = np.load(path)
        ref = np.load(path.replace(str(tmp_path / "port"),
                                   str(tmp_path / "jax")))
        assert set(got.files) == set(ref.files) == {"xyz", "feature"}
        np.testing.assert_array_equal(got["xyz"], ref["xyz"])
        print("rows with a flip in reach",
              _assert_fpfh_rows(got["feature"], ref["feature"], got["xyz"],
                                0.1, 0.25))
    # an existing npz is kept unless --overwrite
    assert precompute_descriptors.main(
        ["--root", str(tmp_path / "port"), "--cpu"]) == []


def test_precompute_fcgf_matches_gmf_tpu(threedmatch_tree, tmp_path):
    """extract_fcgf through the bridged conv1-7 net within 1e-5; the
    command line on a port checkpoint writes those features."""
    jmodel, jvars, net = _fcgf(7)
    xyz = make_dgr_pair(np.random.RandomState(4), n_points=700,
                        voxel_size=0.05, surface=True)["pcd0"]
    from gmf_tpu.sparse.voxelize import sparse_quantize as jax_quantize

    pts, feat = precompute_descriptors.extract_fcgf(xyz, 0.05, net)
    coords, sel = jax_quantize(xyz, 0.05)
    np.testing.assert_array_equal(pts, xyz[sel])
    np.testing.assert_allclose(feat, _jax_fcgf(jmodel, jvars, coords, 7),
                               rtol=0, atol=1e-5)
    torch.manual_seed(0)
    full = precompute_descriptors.FCGFNet(conv1_kernel_size=7)
    ckpt = save_checkpoint(str(tmp_path / "fcgf"), full.state_dict())
    root = tmp_path / "tree"
    shutil.copytree(threedmatch_tree, root)
    written = precompute_descriptors.main(
        ["--root", str(root), "--descriptor", "fcgf", "--checkpoint", ckpt,
         "--cpu"])
    assert len(written) == 2 and written[0].endswith("_fcgf.npz")
    got = np.load(written[0])
    want = precompute_descriptors.extract_fcgf(
        precompute_descriptors.read_ply(written[0].replace(
            "_fcgf.npz", ".ply"))["xyz"], 0.05,
        precompute_descriptors.load_fcgf(ckpt, 7, CPU))
    np.testing.assert_array_equal(got["xyz"], want[0])
    np.testing.assert_array_equal(got["feature"], want[1])
    assert got["feature"].shape[1] == 32


def _png(path, rng, hw):
    import matplotlib.image as mpimg

    mpimg.imsave(path, (rng.rand(*hw, 3) * 255).astype(np.uint8))


@pytest.fixture(scope="module")
def kitti_tree(tmp_path_factory):
    """tests/test_torch_dgr.py's KITTI sequence 08: three frames 6 m apart
    (one pair >= 10 m), an identity calibration."""
    root = tmp_path_factory.mktemp("kitti")
    rng = np.random.RandomState(7)
    kseq = root / "sequences" / "08"
    (kseq / "velodyne").mkdir(parents=True)
    (kseq / "image_2").mkdir()
    (root / "poses").mkdir()
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
        _png(str(kseq / "image_2" / f"{f:06d}.png"), rng, (24, 32))
    np.savetxt(root / "poses" / "08.txt", np.stack(poses))
    with open(kseq / "calib.txt", "w") as f:
        f.write("Tr: " + " ".join(f"{v:.6f}" for v in np.eye(4)[:3].ravel())
                + "\n")
    return root


def test_build_kitti_pairs_matches_gmf_tpu(kitti_tree, tmp_path):
    """FPFH pairs from both command lines, each on its own copy of the
    tree (each refines and caches its own GT)."""
    from gmf_tpu.tools import build_kitti_pairs as jbuild

    for tag in ("port", "jax"):
        shutil.copytree(kitti_tree, tmp_path / tag)
    argv = ["--split", "test", "--image-hw", "24", "32"]
    written = build_kitti_pairs.main(
        ["--root", str(tmp_path / "port"), "--out",
         str(tmp_path / "port_out"), "--cpu"] + argv)
    _run_jax_main(jbuild, ["--root", str(tmp_path / "jax"), "--out",
                           str(tmp_path / "jax_out")] + argv)
    assert [os.path.basename(p) for p in written] == ["8_0_2.npz"]
    got = np.load(written[0])
    ref = np.load(tmp_path / "jax_out" / "fpfh_test" / "8_0_2.npz")
    assert set(got.files) == set(ref.files) == {
        "xyz0", "xyz1", "features0", "features1", "p_image", "q_image",
        "gt_trans"}
    for k in ("xyz0", "xyz1", "p_image", "q_image"):
        np.testing.assert_array_equal(got[k], ref[k])
    np.testing.assert_allclose(got["gt_trans"], ref["gt_trans"], rtol=0,
                               atol=1e-5)
    for k in ("0", "1"):
        print("rows with a flip in reach", _assert_fpfh_rows(
            got["features" + k], ref["features" + k], got["xyz" + k], 0.6,
            1.5))


def test_build_kitti_pairs_fcgf(kitti_tree, tmp_path):
    """The bridged conv1-5 net on the port's device maps within 1e-5 of
    gmf_tpu's on its host maps; the command line on a port checkpoint
    writes the features fcgf_features gives."""
    from gmf_tpu_torch.data.kitti_dgr_loader import read_velodyne_bin

    jmodel, jvars, net = _fcgf(5)
    xyz = read_velodyne_bin(str(kitti_tree / "sequences" / "08" / "velodyne"
                                / "000000.bin"))
    coords = sparse_quantize(xyz, 0.3)[0]
    np.testing.assert_allclose(
        precompute_descriptors.fcgf_features(net, coords),
        _jax_fcgf(jmodel, jvars, coords, 5), rtol=0, atol=1e-5)
    torch.manual_seed(1)
    full = precompute_descriptors.FCGFNet(conv1_kernel_size=5)
    ckpt = save_checkpoint(str(tmp_path / "fcgf"), full.state_dict())
    shutil.copytree(kitti_tree, tmp_path / "tree")
    written = build_kitti_pairs.main(
        ["--root", str(tmp_path / "tree"), "--out", str(tmp_path / "out"),
         "--split", "test", "--descriptor", "fcgf", "--fcgf-checkpoint",
         ckpt, "--image-hw", "24", "32", "--cpu"])
    got = np.load(written[0])
    assert os.path.dirname(written[0]).endswith("fcgf_test")
    c0 = sparse_quantize(xyz, 0.3)[0]
    np.testing.assert_array_equal(
        got["features0"], precompute_descriptors.fcgf_features(
            precompute_descriptors.load_fcgf(ckpt, 5, CPU), c0))


# -- numerics_study and the tools' device default -----------------------------

def test_numerics_study_runs_on_the_cpu(capsys):
    """The study's own numbers: power iteration aligned with eigh; the two
    Kabsch solvers within 1e-4 on the median problem (random
    correspondences make some problems near-degenerate, where the 40-step
    quaternion iteration lies ~1e-3 from the SVD)."""
    out = numerics_study.main(["--cpu", "--batch", "16", "--k", "10"])
    assert out["device"] == "cpu" and out["clock"] == "host clock, CPU"
    assert out["eig_median_cos"] > 0.999
    assert out["kabsch_median_rot_diff"] < 1e-4
    for k in ("power_ms", "eigh_ms", "quat_ms", "svd_ms"):
        assert out[k] > 0
    assert "power-vs-eigh alignment" in capsys.readouterr().out


@pytest.mark.parametrize("tool,argv", [
    (numerics_study, []),
    (precompute_descriptors, ["--root", "."]),
    (build_kitti_pairs, ["--root", ".", "--out", "."]),
])
def test_tools_take_the_card_by_default(tool, argv):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is taken")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tool.main(argv)
