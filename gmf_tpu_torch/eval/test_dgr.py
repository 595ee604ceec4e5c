"""DGR+GMF end-to-end evaluation command line (raw clouds -> register()).

    python -m gmf_tpu_torch.eval.test_dgr --root /data/threedmatch_test \\
        --fcgf-checkpoint CKPT_FCGF --inlier-checkpoint CKPT_INLIER \\
        [--dataset 3dmatch|kitti] [--descriptor fcgf|fpfh] [--use-icp]

Counterpart of ``gmf_tpu/eval/test_dgr.py`` (reference:
GMF_DGR_fcgf/scripts/test_3dmatch.py / test_kitti.py): per pair
``register(xyz0, xyz1, p_image, q_image)``, success by RTE/RRE (3DMatch
0.3 m / 15 deg, KITTI 0.6 m / 5 deg), per-pair rows [success, rre, rte,
scene index, used_safeguard] saved as ``dgr_stats.npy``. Checkpoints are
the port's or ``gmf_tpu``'s (``utils/model_io.py::load_dgr``). Runs on the card unless
``--cpu``. ``--shard-index/--shard-count`` take a strided slice of the
pair list (default this rank's of the world, ``parallel.process_shard``:
the whole list outside one) and ``--merge-shards`` joins the shards'
files. ``--srcdense-rowmode-min`` picks one of gmf_tpu's TPU
probe tiers for its on-device maps, whose maps are all the same; the
port's device builder has one exact probe, so the flag is accepted,
checked and logged, and changes nothing.
"""

from __future__ import annotations

import argparse
import collections
import glob
import logging
import os
import re
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from gmf_tpu_torch.parallel.mesh import process_shard, world_initialized


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--fcgf-checkpoint", required=True)
    ap.add_argument("--inlier-checkpoint", required=True)
    ap.add_argument("--dataset", default="3dmatch",
                    choices=["3dmatch", "kitti"])
    ap.add_argument("--descriptor", default="fcgf", choices=["fcgf", "fpfh"],
                    help="matching descriptor: 'fpfh' is the GMF_DGR_fpfh "
                         "variant (the FCGF checkpoint is then unused by "
                         "register())")
    ap.add_argument("--voxel", type=float, default=None)
    ap.add_argument("--use-icp", action="store_true")
    ap.add_argument("--safeguard-min-weight", type=float, default=None,
                    help="override DGRConfig.safeguard_min_weight (the "
                         "reference's 200-weight wsum gate); 0 ablates the "
                         "RANSAC safeguard")
    ap.add_argument("--out", default="eval_dgr")
    ap.add_argument("--scenes", nargs="*", default=None,
                    help="subset of SCENE_LIST, or KITTI sequences "
                         "(default: all / 8 9 10)")
    ap.add_argument("--tiny", action="store_true",
                    help="tiny net widths (fixtures and smoke runs; the "
                         "checkpoints must match)")
    ap.add_argument("--workers", type=int, default=0,
                    help="prefetch pair IO (PLY + image reads) with N "
                         "threads")
    ap.add_argument("--overlap", type=int, default=1,
                    help="keep K register() calls in flight (threads); "
                         "results are identical to serial")
    ap.add_argument("--frag-cache", type=int, default=256,
                    help="per-fragment feature-cache budget in MB (0 "
                         "disables); results are bit-identical either way")
    ap.add_argument("--shard-index", type=int, default=None,
                    help="this process' strided shard of the pair list "
                         "(default: its rank in the world, else 0)")
    ap.add_argument("--shard-count", type=int, default=None,
                    help="total shard count (default: the world's size, "
                         "else 1)")
    ap.add_argument("--merge-shards", action="store_true",
                    help="skip evaluation; merge OUT/dgr_stats_shard*.npy "
                         "and print the global summary")
    ap.add_argument("--srcdense-rowmode-min", type=int, default=None,
                    metavar="MULT",
                    help="gmf_tpu's switch between two TPU probe tiers of "
                         "its device maps (MULT >= 1); the port's device "
                         "builder has one exact probe, so it changes "
                         "nothing")
    from gmf_tpu_torch.eval.cli import add_device_arg

    add_device_arg(ap)
    return ap.parse_args(argv)


def _summary(stats) -> str:
    ok = stats[stats[:, 0] == 1]
    return (f"recall={stats[:, 0].mean() * 100:.2f}% "
            f"rre={ok[:, 1].mean() if len(ok) else float('nan'):.2f} "
            f"rte={ok[:, 2].mean() if len(ok) else float('nan'):.3f} "
            f"safeguard used {stats[:, 4].mean() * 100:.1f}%")


def merge_shards(out: str, log) -> np.ndarray:
    """Join one consistent set ``dgr_stats_shard<N>of<M>.npy`` under
    ``out``; stale or missing shards stop the command by name."""
    files = sorted(glob.glob(os.path.join(out, "dgr_stats_shard*.npy")))
    if not files:
        raise SystemExit(f"no dgr_stats_shard*.npy under {out}")
    parsed = {}
    for f in files:
        m = re.search(r"shard(\d+)of(\d+)\.npy$", os.path.basename(f))
        if m is None:
            raise SystemExit(
                f"unparseable shard filename {f} (expected "
                "dgr_stats_shard<N>of<M>.npy); remove stale files")
        parsed[f] = (int(m.group(1)), int(m.group(2)))
    counts = {m for _, m in parsed.values()}
    if len(counts) != 1:
        raise SystemExit(f"mixed shard counts {sorted(counts)} under {out}; "
                         "remove stale shard files from previous runs")
    (total,) = counts
    indices = sorted(n for n, _ in parsed.values())
    if indices != list(range(total)):
        raise SystemExit(f"expected shards 0..{total - 1}, found {indices} "
                         f"under {out}")
    loaded = [s for s in (np.load(f) for f in files) if len(s)]
    if not loaded:
        raise SystemExit(f"all shards under {out} are empty")
    stats = np.concatenate(loaded, axis=0)
    log.info(f"[merged {len(files)} shards] All {len(stats)} pairs, "
             + _summary(stats))
    np.save(os.path.join(out, "dgr_stats.npy"), stats)
    return stats


def tiny_nets():
    """The ``--tiny`` FCGF and inlier nets (gmf_tpu's test widths)."""
    from gmf_tpu_torch.sparse.resunet import SparseResUNet2

    narrow = dict(channels=(4, 8, 16, 32), tr_channels=(8, 8, 8, 16))
    return (SparseResUNet2(in_channels=1, out_channels=8, dim=3,
                           conv1_kernel_size=3, normalize_feature=True,
                           **narrow),
            SparseResUNet2(in_channels=1, out_channels=1, dim=6,
                           conv1_kernel_size=3, with_gmf_fusion=True,
                           image_dim=16, **narrow))


def make_engine(args, device):
    """The DGR engine of the checkpoints, in the dataset's preset."""
    from gmf_tpu_torch.configs.presets import dgr_3dmatch, dgr_kitti
    from gmf_tpu_torch.models.dgr import DGRConfig, DeepGlobalRegistration
    from gmf_tpu_torch.sparse.resunet import FCGFNet, GMFInlierNet
    from gmf_tpu_torch.utils.model_io import load_dgr

    tcfg = dgr_kitti() if args.dataset == "kitti" else dgr_3dmatch()
    fcgf_state, inlier_state = load_dgr(args.fcgf_checkpoint,
                                        args.inlier_checkpoint)
    if args.tiny:
        fcgf_model, inlier_model = tiny_nets()
    else:
        fcgf_model = FCGFNet(conv1_kernel_size=tcfg.feat_conv1_kernel_size)
        inlier_model = GMFInlierNet(
            conv1_kernel_size=tcfg.inlier_conv1_kernel_size)
    cfg = DGRConfig(voxel_size=args.voxel or tcfg.voxel_size,
                    use_icp=args.use_icp,
                    clip_weight_thresh=tcfg.clip_weight_thresh,
                    inlier_feature_type=tcfg.inlier_feature_type,
                    descriptor=args.descriptor)
    if args.safeguard_min_weight is not None:
        cfg.safeguard_min_weight = args.safeguard_min_weight
        cfg.safeguard_min_frac = 0.0
    if args.tiny:
        cfg.voxel_cap_granule = cfg.corr_cap_granule = 256
    return DeepGlobalRegistration(
        fcgf_state, inlier_state, cfg, fcgf_model=fcgf_model,
        inlier_model=inlier_model,
        frag_cache_bytes=args.frag_cache * (1 << 20), device=device)


def _pair_loader(args, device, cached_io):
    """Indexable pair IO: items (scene index, scene, "i_j", xyz0, xyz1,
    p_image, q_image, T_gt)."""
    from gmf_tpu_torch.data.imageio import load_image

    if args.dataset == "3dmatch":
        from gmf_tpu_torch.data.ply import read_ply
        from gmf_tpu_torch.data.threedmatch import SCENE_LIST, load_gt_log

        specs = []
        for si, scene in enumerate(args.scenes or SCENE_LIST):
            gt = load_gt_log(os.path.join(args.root, scene))
            base = os.path.join(args.root, scene, "seq-01")
            for key, T_gt_ts in gt.items():
                i, j = key.split("_")
                specs.append((si, scene, key, base, i, j,
                              np.linalg.inv(T_gt_ts)))
        specs = process_shard(specs, args.shard_index, args.shard_count)

        def item(n):
            si, scene, key, base, i, j, T_gt = specs[n]

            def ply(fid):
                p = os.path.join(base, f"cloud_bin_{fid}.ply")
                return cached_io(p, lambda: read_ply(p)["xyz"])

            def img(fid):
                p = os.path.join(base, f"cloud_bin_{fid}_0.png")
                return cached_io(p, lambda: load_image(p)[None])

            return si, scene, key, ply(i), ply(j), img(i), img(j), T_gt

        return _Indexable(len(specs), item)

    # KITTI raw-velodyne protocol (GMF_DGR_fcgf/scripts/test_kitti.py:
    # test sequences 8-10, >= 10 m odometry pairs, ICP-refined GT)
    from gmf_tpu_torch.configs.presets import dgr_kitti
    from gmf_tpu_torch.data.kitti_dgr_loader import (KITTINMPairDataset,
                                                     read_velodyne_bin)

    seqs = [int(s) for s in args.scenes] if args.scenes else [8, 9, 10]
    kds = KITTINMPairDataset(args.root, sequences=seqs,
                             voxel_size=args.voxel or dgr_kitti().voxel_size,
                             device=device)
    kds.pairs = process_shard(kds.pairs, args.shard_index, args.shard_count)

    def item(n):
        seq, t0, t1 = kds.pairs[n]

        def velo(t):
            p = kds._velo_path(seq, t)
            return cached_io(p, lambda: read_velodyne_bin(p))

        def img(t):
            p = kds._image_path(seq, t)
            return cached_io(p, lambda: load_image(p, *kds.image_hw)[None])

        xyz0, xyz1 = velo(t0), velo(t1)
        T_gt = kds.gt_transform(seq, t0, t1, xyz0, xyz1).astype(np.float32)
        return (seq, f"{seq:02d}", f"{t0}_{t1}", xyz0, xyz1, img(t0),
                img(t1), T_gt)

    return _Indexable(len(kds.pairs), item)


class _Indexable:
    """A length and an item function, for the harness's prefetcher."""

    def __init__(self, n, item):
        self._n, self._item = n, item

    def __len__(self):
        return self._n

    def __getitem__(self, n):
        return self._item(n)


def main(argv=None):
    args = parse_args(argv)
    import torch.distributed as dist

    # DP over register() streams: each process takes a disjoint strided
    # shard of the pair list (by default its rank of the world)
    world = world_initialized()
    if args.shard_index is None:
        args.shard_index = dist.get_rank() if world else 0
    if args.shard_count is None:
        args.shard_count = dist.get_world_size() if world else 1
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    log = logging.getLogger("evaldgr")
    if args.srcdense_rowmode_min is not None:
        if args.srcdense_rowmode_min < 1:
            raise SystemExit(f"--srcdense-rowmode-min must be an integer >= "
                             f"1, got {args.srcdense_rowmode_min}")
        log.info(f"--srcdense-rowmode-min {args.srcdense_rowmode_min}: "
                 "no effect; it picks one of gmf_tpu's TPU probe tiers, "
                 "whose maps are the same, and the port's device builder "
                 "has one exact probe (sorted keys)")
    if args.merge_shards:
        return merge_shards(args.out, log)

    from gmf_tpu_torch.eval.harness import _iter_with_data_time
    from gmf_tpu_torch.utils.device import resolve_device
    from gmf_tpu_torch.utils.lru import cache_host_arrays

    device = resolve_device("cpu" if args.cpu else None)
    engine = make_engine(args, device)
    kitti = args.dataset == "kitti"
    rte_thresh, rre_thresh = (0.6, 5.0) if kitti else (0.3, 15.0)

    def cached_io(key, build):
        # decoded clouds and frames, read-only, shared across the pairs a
        # fragment appears in (the process-wide host IO cache)
        return cache_host_arrays(key, lambda: np.asarray(build()))

    loader = _pair_loader(args, device, cached_io)
    rows = []

    def process(item, res):
        si, scene, key, _x0, _x1, _pi, _qi, T_gt = item
        T = res["trans"]
        tr = float(np.trace(T[:3, :3].T @ T_gt[:3, :3]))
        rre = np.degrees(np.arccos(np.clip((tr - 1) / 2, -1, 1)))
        rte = float(np.linalg.norm(T[:3, 3] - T_gt[:3, 3]))
        ok = (rte < rte_thresh) and (rre < rre_thresh)
        rows.append([float(ok), rre, rte, si, float(res["used_safeguard"])])
        log.info(f"{scene} {key}: {'OK' if ok else 'FAIL'} "
                 f"rre={rre:.2f} rte={rte:.3f}")

    def frag_keys(item):
        # key is "<i>_<j>" (3DMatch fragment ids / KITTI frame ids),
        # scoped by scene so that ids never collide across scenes
        _si, scene, key = item[:3]
        a, b = key.split("_")
        return {"cache_key0": f"{scene}:{a}", "cache_key1": f"{scene}:{b}"}

    items = _iter_with_data_time(loader, args.workers)
    if args.overlap > 1:
        with ThreadPoolExecutor(max_workers=args.overlap) as ex:
            inflight = collections.deque()
            for item, _dt in items:
                inflight.append((item, ex.submit(
                    engine.register, *item[3:7], **frag_keys(item))))
                if len(inflight) >= args.overlap:
                    it, fut = inflight.popleft()
                    process(it, fut.result())
            while inflight:
                it, fut = inflight.popleft()
                process(it, fut.result())
    else:
        for item, _dt in items:
            process(item, engine.register(*item[3:7], **frag_keys(item)))

    stats = np.asarray(rows, dtype=np.float64).reshape(-1, 5)
    sharded = args.shard_count > 1
    tag = f" [shard {args.shard_index}/{args.shard_count}]" if sharded else ""
    log.info(f"All {len(stats)} pairs{tag}, " + _summary(stats)
             + (f", frag-cache hits {engine.frag_cache_hits}/"
                f"{2 * len(stats)}" if args.frag_cache else ""))
    os.makedirs(args.out, exist_ok=True)
    name = (f"dgr_stats_shard{args.shard_index}of{args.shard_count}.npy"
            if sharded else "dgr_stats.npy")
    np.save(os.path.join(args.out, name), stats)
    return stats


if __name__ == "__main__":
    main()
