"""gmf_tpu_torch's reconstruction apps (apps/{multiway,tsdf,make_fragments,
multiway_cli}.py, data/redwood.py) vs gmf_tpu's on the same inputs (CPU).

Tolerances, each stated beside its assertion:
- the pose graph (host f64 in both): node poses within 1e-9;
- ate_rmse (an f32 Horn alignment in both): within 1e-6;
- TSDF: both round a voxel's projection half to even, and the products
  that place it may differ in their last bit, so a voxel whose projection
  lies within 1e-4 px of a .5 edge in some frame may gather a
  neighbouring pixel (such voxels are counted and printed); every other
  voxel has an equal weight and a tsdf within 1e-6, and the extracted
  point sets differ only at such voxels;
- make_fragments on tests/test_make_fragments.py's rendered wall, 8
  frames in 2 fragments: poses within 1e-4 (ICP in f32 in both);
- multiway_cli with a bridged PointDSC(num_layers=1, num_channels=16):
  trajectories within 1e-4; on RANSAC the port runs gmf_tpu's own draws
  (``ransac_from_indices``, as tests/test_torch_eval.py's RANSAC test),
  trajectories within 1e-4. Both take gmf_tpu's FPFH of each fragment:
  on 300 points drawn from a fragment an SPFH entry on a bin's edge flips
  apart on the two packages (bounded in tests/test_torch_dgr.py and
  tests/test_torch_tools.py), and a flip moves the 1-NN matches.
"""

import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_eval_fixtures as fx
from gmf_tpu.apps import make_fragments as jmf
from gmf_tpu.apps import multiway as jmw
from gmf_tpu.apps import tsdf as jtsdf
from gmf_tpu.data import redwood as jredwood
from gmf_tpu_torch.apps import make_fragments as mf
from gmf_tpu_torch.apps import multiway as mw
from gmf_tpu_torch.apps import multiway_cli, tsdf
from gmf_tpu_torch.data import redwood
from gmf_tpu_torch.data.dgr_loader import heightfield
from gmf_tpu_torch.data.ply import write_ply
from test_make_fragments import K, cam_pose, render_depth
from torch_apps_fixtures import apart_only_at_edges, edge_voxels

torch.set_num_threads(2)
CPU = "cpu"


@pytest.fixture(scope="module")
def sequence():
    poses = [cam_pose(i) for i in range(8)]
    return [render_depth(p) for p in poses], poses


# -- the pose graph, trajectories, ATE ---------------------------------------

def test_se3_maps_match_gmf_tpu():
    rng = np.random.RandomState(0)
    for scale in (1e-12, 0.05, 0.5, 2.0):
        xi = rng.randn(6) * scale
        np.testing.assert_array_equal(mw.se3_exp(xi), jmw.se3_exp(xi))
        T = jmw.se3_exp(xi)
        np.testing.assert_array_equal(mw.se3_log(T), jmw.se3_log(T))


def _noisy_ring(rng, n=6):
    gt = [np.eye(4)]
    for _ in range(1, n):
        gt.append(gt[-1] @ mw.se3_exp(rng.randn(6) * 0.3))
    nodes, edges = [np.eye(4)], []
    for i in range(n - 1):
        noisy = np.linalg.inv(gt[i]) @ gt[i + 1] @ mw.se3_exp(
            rng.randn(6) * 0.03)
        nodes.append(nodes[-1] @ noisy)
        edges.append((i, i + 1, noisy, np.eye(6), False))
    for j in (n - 1, n - 2):
        edges.append((0, j, gt[j], np.eye(6) * 10, True))
    return gt, nodes, edges


def test_optimize_pose_graph_matches_gmf_tpu():
    """f64 on the host in both: node poses within 1e-9."""
    gt, nodes, edges = _noisy_ring(np.random.RandomState(1))
    got = mw.optimize_pose_graph(mw.PoseGraph(
        nodes=nodes, edges=[mw.PoseGraphEdge(*e) for e in edges]),
        max_iterations=60)
    ref = jmw.optimize_pose_graph(jmw.PoseGraph(
        nodes=nodes, edges=[jmw.PoseGraphEdge(*e) for e in edges]),
        max_iterations=60)
    for a, b in zip(got.nodes, ref.nodes):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-9)
    assert mw.ate_rmse(got.nodes, gt, align=False) < mw.ate_rmse(
        nodes, gt, align=False)


def test_multiway_register_matches_gmf_tpu():
    """A deterministic register_fn (exact relative poses with a fixed
    perturbation, fitness by index): the same edges, nodes within 1e-9."""
    rng = np.random.RandomState(2)
    poses = [np.eye(4)]
    for _ in range(4):
        poses.append(poses[-1] @ mw.se3_exp(rng.randn(6) * 0.2))
    frags = [{"i": i} for i in range(5)]

    def register_fn(fi, fj):
        i, j = fi["i"], fj["i"]
        T = np.linalg.inv(poses[i]) @ poses[j] @ mw.se3_exp(
            np.full(6, 0.01 * (i + 2 * j)))
        return T, 0.3 + 0.1 * i

    got = mw.multiway_register(frags, register_fn, loop_closure_window=2)
    ref = jmw.multiway_register(frags, register_fn, loop_closure_window=2)
    assert [(e.i, e.j, e.uncertain) for e in got.edges] == [
        (e.i, e.j, e.uncertain) for e in ref.edges]
    for a, b in zip(got.nodes, ref.nodes):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-9)


def test_trajectory_io_across_packages_and_ate(tmp_path):
    """A trajectory written by one package and read by the other; ate_rmse
    within 1e-6 (an f32 Horn alignment in both)."""
    rng = np.random.RandomState(3)
    traj = [((i, i, 5), mw.se3_exp(rng.randn(6))) for i in range(5)]
    for write, read, tag in ((mw.write_trajectory, jmw.read_trajectory, "a"),
                             (jmw.write_trajectory, mw.read_trajectory, "b")):
        path = str(tmp_path / f"{tag}.log")
        write(path, traj)
        back = read(path)
        assert [m for m, _ in back] == [m for m, _ in traj]
        for (_, a), (_, b) in zip(back, traj):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-8)
    est = [p for _, p in traj]
    gt = [p @ mw.se3_exp(rng.randn(6) * 0.05) for p in est]
    for align in (True, False):
        np.testing.assert_allclose(
            mw.ate_rmse(est, gt, align=align, device=CPU),
            jmw.ate_rmse(est, gt, align=align), rtol=0, atol=1e-6)


# -- TSDF ---------------------------------------------------------------------

def test_tsdf_integrate_matches_gmf_tpu(sequence):
    """3 frames on a 32^3 grid at 8 cm (tolerances in the module
    docstring)."""
    depths, poses = sequence
    origin, voxel, D = np.array([-1.0, -0.8, 1.4], np.float32), 0.08, 32
    ref = jtsdf.TSDFVolume(origin, (D, D, D), voxel_size=voxel)
    got = tsdf.TSDFVolume(origin, (D, D, D), voxel_size=voxel, device=CPU)
    for d, p in zip(depths[:3], poses[:3]):
        ref.integrate(d, K, p)
        got.integrate(d, K, p)
    assert got.tsdf.device.type == "cpu"
    ijk = np.stack(np.meshgrid(*[np.arange(D)] * 3, indexing="ij"), -1)
    centres = ((ijk + 0.5) * voxel + origin).reshape(-1, 3)
    edge = edge_voxels(centres, poses[:3], K).reshape(D, D, D)
    w_ref, w = np.asarray(ref.weight), got.weight.numpy()
    t_ref, t = np.asarray(ref.tsdf), got.tsdf.numpy()
    assert np.array_equal(w[~edge], w_ref[~edge])
    np.testing.assert_allclose(t[~edge], t_ref[~edge], rtol=0, atol=1e-6)
    apart = apart_only_at_edges(got.extract_point_cloud(),
                                 ref.extract_point_cloud(), poses[:3], K)
    print(f"edge voxels {int(edge.sum())}, weights apart "
          f"{int((w != w_ref).sum())}, tsdf apart by > 1e-6 "
          f"{int((np.abs(t - t_ref) > 1e-6).sum())}, extracted points "
          f"apart {apart}")
    assert (w_ref > 0).sum() > 1000 and len(got.extract_point_cloud()) > 500


# -- make_fragments -----------------------------------------------------------

def test_integrate_fragment_caps_its_grid_as_gmf_tpu(sequence):
    """A grid capped at 16 voxels a side (68 x 52 x 21 uncapped):
    fragment_grid says so, both packages warn alike, and the port's cloud
    lies inside the grid."""
    depths, poses = sequence
    lo, hi, dims, capped = mf.fragment_grid(depths[:2], poses[:2], K, 0.04,
                                            max_dim=16)
    assert capped and list(dims) == [16, 16, 16] and np.all(hi > lo)
    with pytest.warns(UserWarning, match="exceeds the 16-voxel") as port:
        got = mf.integrate_fragment(depths[:2], poses[:2], K, 0.04,
                                    max_dim=16, device=CPU)
    with pytest.warns(UserWarning) as ref:
        jmf.integrate_fragment(depths[:2], poses[:2], K, 0.04, max_dim=16)
    assert [str(w.message) for w in port] == [str(w.message) for w in ref]
    assert len(got) > 100 and np.all((got >= lo) & (got <= lo + dims * 0.04))
    assert not mf.fragment_grid(depths[:2], poses[:2], K, 0.04)[3]


@pytest.fixture(scope="module")
def fragments(sequence, tmp_path_factory):
    """Both packages' make_fragments: 8 frames in 2 fragments at 4 cm."""
    depths, _ = sequence
    root = tmp_path_factory.mktemp("frags")
    kw = dict(n_frames_per_fragment=4, n_keyframes_per_n_frame=2,
              voxel_size=0.04, max_corr_dist=0.10)
    seconds = {}
    got = mf.make_fragments(depths, K, str(root / "port"), device=CPU,
                            seconds=seconds, **kw)
    ref = jmf.make_fragments(depths, K, str(root / "jax"), **kw)
    return got, ref, root, seconds


def test_make_fragments_matches_gmf_tpu(sequence, fragments):
    """Poses within 1e-4; each fragment's cloud differs from gmf_tpu's
    only at voxels on a pixel edge; the port's integration at gmf_tpu's
    poses likewise."""
    depths, _ = sequence
    got, ref, _, seconds = fragments
    assert len(got) == len(ref) == 2
    assert set(seconds) == {"odometry", "pose_graph", "tsdf", "extract"}
    for fid, (a, b) in enumerate(zip(got, ref)):
        assert len(a["pose"]) == len(b["pose"]) == 4
        for Pa, Pb in zip(a["pose"], b["pose"]):
            np.testing.assert_allclose(Pa, Pb, rtol=0, atol=1e-4)
        frame_depths = depths[4 * fid:4 * fid + 4]
        apart_only_at_edges(a["xyz"], b["xyz"], b["pose"], K)
        at_ref = mf.integrate_fragment(frame_depths, b["pose"], K, 0.04,
                                       device=CPU)
        apart_only_at_edges(at_ref, b["xyz"], b["pose"], K)
        assert len(a["xyz"]) > 200


def test_fragment_tree_read_by_both_redwood_datasets(fragments, tmp_path):
    """Each package's written fragments, in the Redwood layout, read by
    each package's RedwoodDataset: the clouds make_fragments returned."""
    got, ref, root, _ = fragments
    for tag, frags in (("port", got), ("jax", ref)):
        scene = tmp_path / tag / "livingroom1"
        shutil.copytree(root / tag, scene / "fragments")
        for ds in (redwood.RedwoodDataset(str(tmp_path / tag)),
                   jredwood.RedwoodDataset(str(tmp_path / tag))):
            assert ds.scene == "livingroom1" and len(ds) == 2
            for i, f in enumerate(frags):
                np.testing.assert_array_equal(ds[i]["xyz"], f["xyz"])
            assert ds.gt_trajectory() is None
        np.testing.assert_array_equal(
            np.load(scene / "fragments" / "fragment_001_pose.npy"), np.eye(4))


def test_make_fragments_cli_reads_png_depth(sequence, tmp_path):
    """16-bit PNG depth (millimetres) read by the port's PNG decoder in
    raw units equals gmf_tpu's Pillow read; the CLI writes the tree."""
    from PIL import Image

    depths, _ = sequence
    ddir = tmp_path / "depth"
    ddir.mkdir()
    for i, d in enumerate(depths[:4]):
        mm = np.round(d * 1000).astype(np.uint16)
        Image.fromarray(mm).save(ddir / f"{i:04d}.png")
    path = str(ddir / "0000.png")
    np.testing.assert_array_equal(mf._read_depth(path, 1000.0),
                                  jmf._read_depth(path, 1000.0))
    np.save(tmp_path / "K.npy", K)
    out = tmp_path / "fragments"
    frags = mf.main(["--depth-dir", str(ddir), "--out", str(out),
                     "--intrinsics", str(tmp_path / "K.npy"),
                     "--n-frames-per-fragment", "2", "--voxel", "0.04",
                     "--max-corr-dist", "0.1", "--cpu"])
    assert len(frags) == 2
    names = sorted(os.listdir(out))
    assert names == ["fragment_000.ply", "fragment_000_pose.npy",
                     "fragment_001.ply", "fragment_001_pose.npy"]


@pytest.mark.parametrize("mode", ["L", "I;16", "LA", "RGB", "RGBA"])
def test_read_png_raw_gives_the_stored_samples(tmp_path, mode):
    """``read_png(raw=True)``: the samples Pillow reads, dtype and shape
    included (the 16-bit depth path above is one case)."""
    from PIL import Image

    from gmf_tpu_torch.data.imageio import read_png

    rng = np.random.RandomState(7)
    ch = {"L": 1, "I;16": 1, "LA": 2, "RGB": 3, "RGBA": 4}[mode]
    dt = np.uint16 if mode == "I;16" else np.uint8
    a = rng.randint(0, np.iinfo(dt).max + 1, (5, 7, ch)).astype(dt)
    img = Image.fromarray(a[..., 0] if ch == 1 else a)
    assert img.mode == mode
    path = str(tmp_path / "x.png")
    img.save(path)
    got, ref = read_png(path, raw=True), np.asarray(Image.open(path))
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def test_entry_points_take_the_card_by_default():
    if torch.cuda.is_available():
        assert tsdf.TSDFVolume([0, 0, 0], (2, 2, 2)).tsdf.is_cuda
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsdf.TSDFVolume([0, 0, 0], (2, 2, 2))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mw.ate_rmse([np.eye(4)] * 3, [np.eye(4)] * 3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mf.main(["--depth-dir", ".", "--out", "."])


# -- Redwood pairs ------------------------------------------------------------

def _pair_tree(root, rng):
    """gmf_tpu's tests/test_tsdf.py pair layout: three fragments with FPFH
    npz and world poses; the third 50 m away (no overlap)."""
    scene = "livingroom1-simulated"
    frag_dir = root / scene / "fragments"
    os.makedirs(frag_dir)
    base = rng.rand(120, 3).astype(np.float32) * 2
    feat = rng.randn(120, 33).astype(np.float32)
    for i, (ang, far) in enumerate(((0.0, 0), (0.3, 0), (2.0, 1))):
        T = mw.se3_exp(np.array([0.1 * ang, 0, 9.0 * far, 0, 0, ang]))
        world = base + np.float32([50.0 * far, 0, 0])
        inv = np.linalg.inv(T)
        xyz = (world @ inv[:3, :3].T + inv[:3, 3]).astype(np.float32)
        np.savez(frag_dir / f"fragment_{i:03d}_fpfh.npz", xyz=xyz,
                 feature=feat + 0.01 * rng.randn(*feat.shape))
        np.save(frag_dir / f"fragment_{i:03d}.npy", T)
    return scene


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_redwood_pairs_and_overlap_cache_across_packages(tmp_path, writer):
    """The overlap pickle one package writes is what the other reads, and
    both give the same samples (the same RandomState draws)."""
    scene = _pair_tree(tmp_path, np.random.RandomState(4))
    first, second = ((redwood, jredwood) if writer == "port"
                     else (jredwood, redwood))
    kw = dict(descriptor="fpfh", min_overlap=0.0, num_node=50)
    a = first.RedwoodPairDataset(str(tmp_path), scene,
                                 rng=np.random.RandomState(0), **kw)
    assert (tmp_path / f"{scene}-overlap.pkl").exists()
    b = second.RedwoodPairDataset(str(tmp_path), scene,
                                  rng=np.random.RandomState(0), **kw)
    assert a.gt_overlap == b.gt_overlap
    assert all(type(v) is float for v in a.gt_overlap.values())
    assert a.keys == b.keys and len(a) == 3
    for i in range(len(a)):
        sa, sb = a[i], b[i]
        assert sa.keys() == sb.keys()
        for k in sa:
            if isinstance(sa[k], np.ndarray):
                np.testing.assert_array_equal(sa[k], sb[k])
            else:
                assert sa[k] == sb[k]
    filt = redwood.RedwoodPairDataset(str(tmp_path), scene, min_overlap=0.3,
                                      descriptor="fpfh")
    assert filt.keys == [f"{scene}@0_1"]


def test_min_dist_below_matches_gmf_tpu():
    rng = np.random.RandomState(5)
    a, b = rng.rand(200, 3), rng.rand(150, 3)
    np.testing.assert_array_equal(redwood._min_dist_below(a, b, 0.05),
                                  jredwood._min_dist_below(a, b, 0.05))


# -- multiway_cli -------------------------------------------------------------

@pytest.fixture(scope="module")
def scene_tree(tmp_path_factory):
    """Four overlapping fragments of one bumpy 3 m x 1 m surface, each in
    its own frame (PLY), a gt.log of their poses, and the tiny PointDSC
    saved by gmf_tpu and, bridged, by the port."""
    root = tmp_path_factory.mktemp("redwood")
    rng = np.random.RandomState(6)
    world = heightfield(rng, 12000) * np.float32([3.0, 1.0, 2.0])
    frag_dir = root / "livingroom1" / "fragments"
    os.makedirs(frag_dir)
    traj = []
    for i in range(4):
        sel = (world[:, 0] >= 0.5 * i) & (world[:, 0] < 0.5 * i + 1.5)
        pose = mw.se3_exp(np.array([0.5 * i, 0.05 * i, 0.02, 0.02 * i,
                                    -0.03 * i, 0.1 * i]))
        inv = np.linalg.inv(pose)
        xyz = world[sel] @ inv[:3, :3].T + inv[:3, 3]
        xyz = xyz + 0.002 * rng.randn(*xyz.shape)
        write_ply(str(frag_dir / f"fragment_{i:03d}.ply"),
                  xyz.astype(np.float32))
        traj.append(((i, i, 4), pose))
    mw.write_trajectory(str(root / "livingroom1" / "gt.log"), traj)
    jax_ckpt, port_ckpt = fx.write_checkpoints(str(root))
    return root, jax_ckpt, port_ckpt


def _jax_multiway(argv):
    from gmf_tpu.apps import multiway_cli as jax_cli

    saved = sys.argv
    sys.argv = ["multiway_cli"] + argv
    try:
        jax_cli.main()
    finally:
        sys.argv = saved


def _jax_draw_ransac(generator, src, tgt, inlier_threshold, num_iters):
    """gmf_tpu's draw for PRNGKey(0) (gmf_tpu/geometry/ransac.py:45-49),
    fed to the port's RANSAC."""
    from gmf_tpu_torch.geometry.ransac import ransac_from_indices

    total = -(-num_iters // 1024) * 1024
    idx = jax.random.randint(jax.random.PRNGKey(0), (total, 3), 0,
                             src.shape[0])
    return ransac_from_indices(src, tgt, torch.from_numpy(
        np.array(idx)).long(), inlier_threshold)


def _jax_fpfh(xyz, **kw):
    """gmf_tpu's FPFH of the port's points, on their device."""
    from gmf_tpu.ops.fpfh import compute_fpfh as jax_fpfh

    feat = np.asarray(jax_fpfh(jnp.asarray(xyz.cpu().numpy()), **kw))
    return torch.from_numpy(feat.copy()).to(xyz.device)


@pytest.mark.parametrize("solver", ["pointdsc", "ransac"])
def test_multiway_cli_matches_gmf_tpu(scene_tree, tmp_path, monkeypatch,
                                      solver):
    root, jax_ckpt, port_ckpt = scene_tree
    monkeypatch.setattr(multiway_cli, "compute_fpfh", _jax_fpfh)
    argv = ["--root", str(root), "--num-node", "300", "--loop-window", "1"]
    jargv, pargv = list(argv), list(argv)
    if solver == "pointdsc":
        jargv += ["--checkpoint", jax_ckpt]
        pargv += ["--checkpoint", port_ckpt]
    else:
        monkeypatch.setattr(multiway_cli, "ransac_registration",
                            _jax_draw_ransac)
    _jax_multiway(jargv + ["--out", str(tmp_path / "jax.log"), "--cpu"])
    res = multiway_cli.main(pargv + ["--out", str(tmp_path / "port.log"),
                                     "--cpu"])
    ref = [p for _, p in jmw.read_trajectory(str(tmp_path / "jax.log"))]
    got = [p for _, p in mw.read_trajectory(str(tmp_path / "port.log"))]
    assert len(got) == len(ref) == 4
    for a, b, c in zip(got, ref, res["poses"]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)
        np.testing.assert_allclose(a, c, rtol=0, atol=1e-7)
    gt = [p for _, p in mw.read_trajectory(
        str(root / "livingroom1" / "gt.log"))]
    assert res["ate"] == pytest.approx(mw.ate_rmse(got, gt, device=CPU),
                                       abs=1e-6)
    print(f"{solver}: ATE {res['ate']:.4f} m")
