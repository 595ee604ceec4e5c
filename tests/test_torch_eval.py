"""The port's evaluation stack vs gmf_tpu's: benchmark_utils, the harness's
statistics, RANSAC (on gmf_tpu's own draws) and ICP, the four evaluation
command lines on one fixture tree (tests/torch_eval_fixtures.py) with the
same weights (a gmf_tpu checkpoint and its bridge), the micro-batching
service, and the training command line on 3DMatch fixtures.

Bounds of the CLI statistics (all_stats.npy): success equal, RE within
0.1 deg and TE within 0.2 cm (from tests/test_fused_model.py's
final_trans atol 1e-3), the input inlier count and ratio equal,
precision, recall and F1 within 0.01. gmf_tpu runs on the CPU in its
CPU defaults (dense attention, f32); the port under ``--cpu`` in the same
(its kernels' plain versions).
"""

import logging
import os
import random
import re
import sys

import numpy as np
import pytest
import torch

import torch_eval_fixtures as fx
from gmf_tpu.eval import benchmark_utils as jax_bu
from gmf_tpu.eval import harness as jax_harness
from gmf_tpu.eval import test_3dlomatch as jax_lomatch_cli
from gmf_tpu.eval import test_3dmatch as jax_3dmatch_cli
from gmf_tpu.eval import test_kitti as jax_kitti_cli
from gmf_tpu.eval import test_recurrent as jax_recurrent_cli
from gmf_tpu_torch.eval import benchmark_utils as bu
from gmf_tpu_torch.eval import harness
from gmf_tpu_torch.eval import test_3dlomatch, test_3dmatch, test_kitti
from gmf_tpu_torch.eval import test_recurrent
from gmf_tpu_torch.utils.lru import host_io_cache

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("eval"))
    t = fx.write_3dmatch_tree(root)
    t["kitti"] = fx.write_kitti_tree(os.path.join(root, "kitti"))
    t["jax_ckpt"], t["port_ckpt"] = fx.write_checkpoints(root)
    return t


# -- benchmark_utils and the harness's statistics ---------------------------

def _rigid(rng, noise=0.0):
    T = np.eye(4)
    T[:3, :3] = fx._rot(rng.rand() * 3, rng.rand() * 3)
    T[:3, 3] = rng.rand(3)
    T[:3, 3] += noise * rng.randn(3)
    return T


def test_benchmark_utils_match_jax(tmp_path):
    rng = np.random.RandomState(0)
    errors = rng.rand(50) * 20
    assert bu.exact_auc(errors, [5, 10, 20]) == jax_bu.exact_auc(
        errors, [5, 10, 20])
    R = _rigid(rng)[:3, :3]
    np.testing.assert_array_equal(bu.rot_to_euler(R), jax_bu.rot_to_euler(R))
    info = np.eye(6) + 0.1 * np.diag(rng.rand(6))
    Tg, Te = _rigid(rng), _rigid(rng)
    Te_near = Tg.copy()
    Te_near[:3, 3] += 0.01
    for est in (Te, Te_near):
        assert bu.compute_transformation_error(est, Tg, info) == \
            jax_bu.compute_transformation_error(est, Tg, info)
    gt = {(0, 2): Tg, (1, 3): Tg, (0, 1): Tg, (2, 5): Te}
    est = {(0, 2): Te_near, (1, 3): Te, (2, 5): Te}
    infos = {k: info for k in gt}
    assert bu.evaluate_registration_rmse(est, gt, infos) == \
        jax_bu.evaluate_registration_rmse(est, gt, infos)
    log, gti = tmp_path / "gt.log", tmp_path / "gt.info"
    with open(log, "w") as f, open(gti, "w") as g:
        for (i, j), T in gt.items():
            f.write(f"{i} {j} 6\n" + "\n".join(
                " ".join(f"{v:.9f}" for v in row) for row in T) + "\n")
            g.write(f"{i} {j} 6\n" + "\n".join(
                " ".join(f"{v:.9f}" for v in row) for row in info) + "\n")
    for fn in ("read_gt_pairs", "read_gt_info"):
        path = log if fn == "read_gt_pairs" else gti
        got, ref = getattr(bu, fn)(path), getattr(jax_bu, fn)(path)
        assert list(got) == list(ref)
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k])
    bu.set_seed(7)
    draws = (random.random(), np.random.rand(), torch.rand(1).item())
    bu.set_seed(7)
    assert draws == (random.random(), np.random.rand(), torch.rand(1).item())
    jax_bu.set_seed(7)
    assert draws[:2] == (random.random(), np.random.rand())


def test_pair_stats_aggregate_report_match_jax():
    rng = np.random.RandomState(1)
    stats = {}
    for si, scene in enumerate(("a", "b")):
        rows = []
        for p in range(4):
            Tg = _rigid(rng)
            Tp = Tg.copy() if p % 3 else _rigid(rng)
            Tp[:3, 3] += 0.01 * p
            n = 60
            gt = (rng.rand(n) < 0.4).astype(np.float32)
            pred = (rng.rand(n) < 0.5).astype(np.float32)
            mask = (np.arange(n) < n - 5 * p).astype(np.float32)
            src = rng.rand(n, 3)
            args = (Tp, Tg, src, src, pred, gt, 15.0, 30.0, 0.1 * p, 0.01,
                    si)
            got = harness.compute_pair_stats(*args, mask=mask).to_row()
            ref = jax_harness.compute_pair_stats(*args, mask=mask).to_row()
            np.testing.assert_array_equal(got, ref)
            rows.append(got)
        stats[scene] = np.stack(rows)
    got, ref = harness.aggregate_scenes(stats), \
        jax_harness.aggregate_scenes(stats)
    for k in ("scene_avg", "pair_avg", "all_stats"):
        np.testing.assert_array_equal(got[k], ref[k])
    for k in ("recall_pct", "re_deg", "te_cm", "num_pairs"):
        assert got[k] == ref[k]
    assert harness.format_report(got) == jax_harness.format_report(ref)
    assert harness.STAT_COLUMNS == jax_harness.STAT_COLUMNS


# -- RANSAC and ICP -----------------------------------------------------------

def _noisy_pair(rng, n=200, outliers=0.6):
    src = (rng.rand(n, 3) * 2).astype(np.float32)
    T = _rigid(rng).astype(np.float32)
    tgt = (src @ T[:3, :3].T + T[:3, 3]
           + 0.005 * rng.randn(n, 3)).astype(np.float32)
    out = rng.rand(n) < outliers
    tgt[out] = rng.rand(out.sum(), 3) * 2
    return src, tgt, T


@pytest.mark.parametrize("masked", [False, True])
def test_ransac_on_jax_draws(masked):
    """gmf_tpu's draws fed to the port: the same best hypothesis (the same
    inliers) and T within 1e-5."""
    import jax
    import jax.numpy as jnp

    from gmf_tpu.geometry.ransac import ransac_registration as jax_ransac
    from gmf_tpu_torch.geometry.ransac import ransac_from_indices

    rng = np.random.RandomState(2)
    src, tgt, _ = _noisy_pair(rng)
    mask = (rng.rand(len(src)) < 0.8).astype(np.float32) if masked else None
    key, total = jax.random.PRNGKey(0), 5 * 1024
    T_ref, inl_ref, fit_ref = jax_ransac(
        key, jnp.asarray(src), jnp.asarray(tgt), inlier_threshold=0.1,
        num_iters=5000, mask=None if mask is None else jnp.asarray(mask))
    if mask is None:  # gmf_tpu/geometry/ransac.py:49-57, its draw
        idx = jax.random.randint(key, (total, 3), 0, len(src))
    else:
        m = jnp.asarray(mask).astype(bool)
        n_val = jnp.maximum(m.sum(), 1)
        u = jax.random.uniform(key, (total, 3))
        idx = jnp.argsort(~m)[jnp.minimum((u * n_val).astype(jnp.int32),
                                          n_val - 1)]
    T, inl, fit = ransac_from_indices(
        torch.from_numpy(src), torch.from_numpy(tgt),
        torch.from_numpy(np.asarray(idx)).long(), 0.1,
        mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_array_equal(inl.numpy(), np.asarray(inl_ref))
    np.testing.assert_allclose(T.numpy(), np.asarray(T_ref), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(float(fit), float(fit_ref), rtol=1e-6)


@pytest.mark.parametrize("kind", ["point", "plane"])
def test_icp_matches_jax(kind):
    import jax.numpy as jnp

    from gmf_tpu.geometry import icp as jax_icp
    from gmf_tpu_torch.geometry import icp

    rng = np.random.RandomState(3)
    src, _, T = _noisy_pair(rng, outliers=0.0)
    tgt = (src @ T[:3, :3].T + T[:3, 3]
           + 0.002 * rng.randn(*src.shape)).astype(np.float32)
    init = T.copy()
    init[:3, 3] += 0.03
    init[:3, :3] = init[:3, :3] @ fx._rot(0.02, 0.01).astype(np.float32)
    tmask = (rng.rand(len(tgt)) < 0.9).astype(np.float32)
    args = [src, tgt, init]
    if kind == "plane":
        args.insert(2, fx._unit(rng.randn(len(tgt), 3)))
    fn = "icp_refine" if kind == "point" else "icp_point_to_plane"
    ref = getattr(jax_icp, fn)(*map(jnp.asarray, args), max_corr_dist=0.1,
                               num_iters=20, tgt_mask=jnp.asarray(tmask))
    got = getattr(icp, fn)(*map(torch.from_numpy, args), max_corr_dist=0.1,
                           num_iters=20, tgt_mask=torch.from_numpy(tmask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)


# -- the evaluation command lines ---------------------------------------------

def _jax_cli(module, argv):
    """A gmf_tpu CLI (it reads sys.argv) on the CPU."""
    saved = sys.argv
    sys.argv = [module.__name__] + argv
    try:
        module.main()
    finally:
        sys.argv = saved


def _stats(out):
    return np.load(os.path.join(out, "all_stats.npy"))


def _assert_stats_close(got, ref):
    assert got.shape == ref.shape and got.shape[1] == 12
    np.testing.assert_array_equal(got[:, 0], ref[:, 0])
    np.testing.assert_allclose(got[:, 1], ref[:, 1], rtol=0, atol=0.1)
    np.testing.assert_allclose(got[:, 2], ref[:, 2], rtol=0, atol=0.2)
    np.testing.assert_array_equal(got[:, 3:5], ref[:, 3:5])
    np.testing.assert_allclose(got[:, 6:9], ref[:, 6:9], rtol=0, atol=0.01)
    np.testing.assert_array_equal(got[:, 11], ref[:, 11])


def _cli_args(trees, case):
    r = trees["root"]
    return {
        "3dmatch": (test_3dmatch, jax_3dmatch_cli,
                    ["--root", r, "--num-node", "all", "--scenes",
                     fx.SCENE]),
        "3dmatch_ransac_icp": (test_3dmatch, jax_3dmatch_cli,
                               ["--root", r, "--num-node", "all", "--scenes",
                                fx.SCENE, "--solver", "RANSAC",
                                "--use-icp"]),
        "3dmatch_device_match": (test_3dmatch, jax_3dmatch_cli,
                                 ["--root", r, "--scenes", fx.SCENE,
                                  "--device-match"]),
        "kitti": (test_kitti, jax_kitti_cli,
                  ["--root", trees["kitti"], "--num-node", "150",
                   "--solver", "RANSAC", "--use-icp"]),
        "3dlomatch": (test_3dlomatch, jax_lomatch_cli,
                      ["--root", r, "--pair-file", trees["pair_file"],
                       "--num-node", "all"]),
    }[case]


@pytest.mark.parametrize("case", ["3dmatch", "3dmatch_ransac_icp",
                                  "3dmatch_device_match", "kitti",
                                  "3dlomatch"])
def test_cli_matches_jax(trees, tmp_path, case):
    port, jax_cli, argv = _cli_args(trees, case)
    np.random.seed(0)
    _jax_cli(jax_cli, argv + ["--checkpoint", trees["jax_ckpt"], "--out",
                              str(tmp_path / "jax")])
    host_io_cache().reset()
    np.random.seed(0)
    agg = port.main(argv + ["--checkpoint", trees["port_ckpt"], "--out",
                            str(tmp_path / "port"), "--cpu"])
    got, ref = _stats(tmp_path / "port"), _stats(tmp_path / "jax")
    np.testing.assert_array_equal(agg["all_stats"], got)
    _assert_stats_close(got, ref)
    assert got[:, 0].mean() >= 2 / 3  # the fixtures register


def test_3dmatch_batched_equals_serial(trees, tmp_path):
    """--batch 2 --inflight 2 --workers 2 gives the serial statistics,
    but the times."""
    base = ["--root", trees["root"], "--scenes", fx.SCENE, "--checkpoint",
            trees["port_ckpt"], "--cpu"]
    serial = test_3dmatch.main(base + ["--out", str(tmp_path / "s")])
    batched = test_3dmatch.main(base + ["--out", str(tmp_path / "b"),
                                        "--batch", "2", "--inflight", "2",
                                        "--workers", "2"])
    cols = [c for c in range(12) if c not in (9, 10)]
    np.testing.assert_array_equal(batched["all_stats"][:, cols],
                                  serial["all_stats"][:, cols])


@pytest.mark.parametrize("case,flags,refusal", [
    ("3dmatch", ["--cpu", "--mesh", "2"], None),
    ("kitti", ["--mesh", "2"], "--mesh 2 needs 2 cards"),
    ("3dlomatch", ["--cpu", "--mesh", "2", "--ring", "2"],
     "mutually exclusive"),
    ("3dlomatch", ["--cpu", "--ring", "2"], None),
    ("3dlomatch", ["--cpu", "--ring", "7"], "no bucket divides"),
])
def test_cli_mesh_and_ring(trees, tmp_path, case, flags, refusal):
    """--mesh 2 (batches of 2 sharded over 2 CPU ranks) and --ring 2 (the
    ring model over 2 CPU ranks) give the one-rank statistics; the
    refusals gmf_tpu keeps stop the command by name and write nothing:
    N above the cards (here none), --ring with --mesh, a ring that no
    bucket divides."""
    port, _, argv = _cli_args(trees, case)
    argv = argv + ["--checkpoint", trees["port_ckpt"], "--batch", "2"]
    out = tmp_path / "n"
    if refusal:
        with pytest.raises(SystemExit, match=re.escape(refusal)):
            port.main(argv + ["--out", str(out)] + flags)
        assert not os.path.exists(out / "all_stats.npy")
        return
    one = port.main(argv + ["--out", str(tmp_path / "one"), "--cpu"])
    many = port.main(argv + ["--out", str(out)] + flags)
    np.testing.assert_array_equal(many["all_stats"], _stats(out))
    _assert_stats_close(many["all_stats"], one["all_stats"])


def test_recurrent_matches_jax(trees, tmp_path, caplog):
    """Both sweeps over two checkpoints (the same weights in both
    packages) and a file that is no checkpoint: the same recall per
    checkpoint, the same best."""
    for seed in (0, 1):
        jax_path, port_path = fx.write_checkpoints(
            str(tmp_path), name=f"epoch_{seed}", seed=seed)
    for side in ("jax", "port"):
        with open(tmp_path / side / "notes.pkl", "wb") as f:
            f.write(b"not a checkpoint")
    argv = ["--root", trees["root"], "--scenes", fx.SCENE]
    with caplog.at_level(logging.INFO):
        _jax_cli(jax_recurrent_cli,
                 argv + ["--snapshot-dir", str(tmp_path / "jax")])
        ref = dict(re.findall(r"(epoch_\d): recall=([\d.]+)%", caplog.text))
        caplog.clear()
        best, recall = test_recurrent.main(
            argv + ["--snapshot-dir", str(tmp_path / "port"), "--cpu"])
        got = dict(re.findall(r"(epoch_\d): recall=([\d.]+)%", caplog.text))
    assert "skip" in caplog.text and "notes.pkl" in caplog.text
    assert got == ref and len(got) == 2
    assert f"{recall:.2f}" == max(ref.values(), key=float)
    assert os.path.basename(best) in ref


# -- the service --------------------------------------------------------------

@pytest.fixture(scope="module")
def registrar(trees):
    from gmf_tpu_torch.data.threedmatch import ThreeDMatchTest
    from gmf_tpu_torch.eval.registration import PointDSCRegistrar
    from gmf_tpu_torch.utils.model_io import load_pointdsc

    model = load_pointdsc(trees["port_ckpt"], device="cpu")
    ds = ThreeDMatchTest(root=trees["root"], select_scene=fx.SCENE)
    return PointDSCRegistrar(model), [ds[i] for i in range(len(ds))]


def test_service_matches_registrar(registrar):
    """Pairs submitted from threads come back as direct register_batch
    calls on the same pairs give them."""
    from concurrent.futures import ThreadPoolExecutor

    from gmf_tpu_torch.eval.serving import RegistrationService

    reg, pairs = registrar
    pairs = pairs * 3
    direct = [reg.register_batch([dict(p)])[0] for p in pairs]
    with RegistrationService(reg, max_batch=4, max_wait_ms=20.0) as svc:
        svc.warmup([256])
        with ThreadPoolExecutor(3) as ex:
            futs = list(ex.map(lambda p: svc.submit(dict(p)), pairs))
        got = [f.result(timeout=120) for f in futs]
    for (t, lab), (t_ref, lab_ref) in zip(got, direct):
        np.testing.assert_allclose(t, t_ref, rtol=0, atol=1e-5)
        np.testing.assert_array_equal(lab, lab_ref)


def test_service_malformed_sample_fails_its_future_only(registrar):
    from gmf_tpu_torch.eval.serving import RegistrationService

    reg, pairs = registrar
    with RegistrationService(reg, max_batch=4, max_wait_ms=15.0) as svc:
        bad = svc.submit({"not_a_sample": 1})
        good = svc.submit(dict(pairs[0]))
        with pytest.raises(KeyError):
            bad.result(timeout=60)
        trans, labels = good.result(timeout=120)
    np.testing.assert_allclose(trans, reg.register_batch([dict(pairs[0])])
                               [0][0], rtol=0, atol=1e-5)
    with pytest.raises(RuntimeError, match="closed"):
        svc.submit(dict(pairs[0]))


# -- training on 3DMatch fixtures ---------------------------------------------

def test_train_3dmatch_prefetch_same_metrics(trees, tmp_path):
    """Two steps of --dataset 3DMatch --tiny --cpu; --prefetch 2 gives the
    metrics of --prefetch 0."""
    from gmf_tpu_torch.train import train_pointdsc

    history = {}
    for depth in (0, 2):
        host_io_cache().reset()
        random.seed(0)
        np.random.seed(0)
        history[depth] = train_pointdsc.main([
            "--dataset", "3DMatch", "--root", trees["root"],
            "--overlap-path", trees["overlap_path"], "--num-node", "64",
            "--batch-size", "2", "--max-epoch", "1", "--steps-per-epoch",
            "2", "--tiny", "--cpu", "--prefetch", str(depth), "--save-dir",
            str(tmp_path / f"p{depth}")])
        assert os.path.exists(tmp_path / f"p{depth}" / "model_best"
                              / "state.pt")
    assert [h[:2] for h in history[0]] == [("eval", 0), ("train", 1),
                                          ("eval", 1)]
    for (_, _, m0), (_, _, m2) in zip(history[0], history[2]):
        assert m0.keys() == m2.keys()
        for k in m0:
            assert np.isfinite(m0[k]), k
            np.testing.assert_allclose(m2[k], m0[k], rtol=1e-6, err_msg=k)


def test_service_batches_requests_queued_during_a_dispatch(registrar):
    """A dispatch that blocks (as the port's does, through its forward's
    syncs): the requests submitted meanwhile go out in full flushes, not
    one a flush, and still get register_batch's results."""
    import threading
    import time

    from gmf_tpu_torch.eval.serving import RegistrationService

    reg, pairs = registrar
    started, sizes = threading.Event(), []

    class Blocking:
        eval_bucket = staticmethod(reg.eval_bucket)
        register_batch = staticmethod(reg.register_batch)
        fetch_batch = staticmethod(reg.fetch_batch)

        @staticmethod
        def dispatch_batch(samples):
            sizes.append(len({s["tag"] for s in samples}))  # pads: copies
            started.set()
            time.sleep(0.3)
            return reg.dispatch_batch(samples)

    with RegistrationService(Blocking(), max_batch=4, max_wait_ms=5.0,
                             inflight=1) as svc:
        first = svc.submit(dict(pairs[0], tag=-1))
        assert started.wait(30)
        rest = [svc.submit(dict(pairs[i % len(pairs)], tag=i))
                for i in range(8)]
        got = [f.result(timeout=120) for f in [first] + rest]
    assert sizes == [1, 4, 4], sizes
    for i, (t, lab) in enumerate(got):
        t_ref, lab_ref = reg.register_batch(
            [dict(pairs[(i - 1) % len(pairs)] if i else pairs[0])])[0]
        # rows of a batch are independent in eval mode
        np.testing.assert_allclose(t, t_ref, rtol=0, atol=1e-5)
        np.testing.assert_array_equal(lab, lab_ref)
