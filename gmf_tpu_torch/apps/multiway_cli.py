"""Multiway registration command line.

Counterpart of ``gmf_tpu/apps/multiway_cli.py`` (GMF_PointDSC/multiway/
test_multi.py): register all fragments of a Redwood/ICL-NUIM scene
pairwise, optimize the pose graph, write the trajectory, report ATE when
ground truth is available.

Each fragment is voxelized, subsampled to ``--num-node`` points (NumPy,
``RandomState(0)`` as in ``gmf_tpu``) and described by FPFH on the
device; the pairs' correspondences are built on the host. With
``--checkpoint`` every pair goes through ``PointDSCRegistrar`` (the
attention, NMS, seed kNN and hypothesis-count kernels and bf16 modules
on the card; under ``--cpu`` the dense f32 model, the evaluation command
lines' CPU default), else through RANSAC drawn from a
``torch.Generator`` seeded 0 on the device (its draws are not
``jax.random``'s). Runs on the card unless ``--cpu``.

Usage:
  python -m gmf_tpu_torch.apps.multiway_cli --root /data/redwood \\
      [--scene livingroom1] [--checkpoint snap/model_best] \\
      [--loop-window 3] [--out traj.log] [--cpu]
"""

from __future__ import annotations

import argparse
from typing import Dict

import numpy as np
import torch

from gmf_tpu_torch.apps.multiway import (ate_rmse, multiway_register,
                                         write_trajectory)
from gmf_tpu_torch.data.correspondence import build_correspondences
from gmf_tpu_torch.data.redwood import RedwoodDataset
from gmf_tpu_torch.geometry.ransac import ransac_registration
from gmf_tpu_torch.ops.fpfh import compute_fpfh
from gmf_tpu_torch.sparse.voxelize import sparse_quantize
from gmf_tpu_torch.utils.device import resolve_device


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--scene", default=None)
    ap.add_argument("--checkpoint", default=None,
                    help="PointDSC checkpoint (RANSAC if absent)")
    ap.add_argument("--voxel", type=float, default=0.05)
    ap.add_argument("--num-node", type=int, default=1000)
    ap.add_argument("--loop-window", type=int, default=2)
    ap.add_argument("--out", default="trajectory.log")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the card)")
    return ap.parse_args(argv)


def make_registrar(checkpoint: str, device):
    """The checkpoint's PointDSC behind a registrar on ``device``: the
    attention kernels and bf16 modules on the card, the dense f32 model
    on the CPU."""
    from gmf_tpu_torch.eval.registration import PointDSCRegistrar
    from gmf_tpu_torch.utils.model_io import load_pointdsc

    on_card = device.type == "cuda"
    model = load_pointdsc(checkpoint, device=device, fused_attention=on_card,
                          dtype=torch.bfloat16 if on_card else torch.float32)
    return PointDSCRegistrar(model)


def main(argv=None) -> Dict[str, object]:
    """Returns {"poses": the optimized node poses, "ate": the ATE RMSE in
    metres or None}."""
    args = parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)

    ds = RedwoodDataset(args.root, args.scene)
    print(f"scene {ds.scene}: {len(ds)} fragments")

    registrar = None
    if args.checkpoint:
        registrar = make_registrar(args.checkpoint, device)

    rng = np.random.RandomState(0)

    def prep(xyz):
        _, sel = sparse_quantize(xyz, args.voxel)
        pts = xyz[sel].astype(np.float32)
        if len(pts) > args.num_node:
            pts = pts[rng.choice(len(pts), args.num_node, replace=False)]
        feat = compute_fpfh(
            torch.as_tensor(pts, device=device),
            normal_radius=2 * args.voxel,
            feature_radius=5 * args.voxel).cpu().numpy()
        return pts, feat

    cache = {}

    def register_fn(fi, fj):
        ki, kj = id(fi), id(fj)
        if ki not in cache:
            cache[ki] = prep(fi["xyz"])
        if kj not in cache:
            cache[kj] = prep(fj["xyz"])
        pts0, feat0 = cache[ki]
        pts1, feat1 = cache[kj]
        sample = build_correspondences(
            pts0, pts1, feat0, feat1, np.eye(4, dtype=np.float32),
            inlier_threshold=2 * args.voxel, use_mutual=False)
        if sample is None:
            return np.eye(4, dtype=np.float32), 0.0
        if registrar is not None:
            H, W = 120, 160
            sample["p_image"] = np.full((H, W, 3), 0.5, np.float32)
            sample["q_image"] = np.full((H, W, 3), 0.5, np.float32)
            T, labels = registrar(sample)
            fit = float(labels.mean())
        else:
            gen = torch.Generator(device=device)
            gen.manual_seed(0)
            T, _, fit = ransac_registration(
                gen, torch.as_tensor(sample["src_keypts"], device=device),
                torch.as_tensor(sample["tgt_keypts"], device=device),
                inlier_threshold=2 * args.voxel, num_iters=4096)
            T, fit = T.cpu().numpy(), float(fit)
        # register_fn must return T_ij taking fragment j into fragment i's
        # frame: the correspondences map src(i)->tgt(j), so invert.
        return np.linalg.inv(np.asarray(T, np.float64)).astype(np.float32), fit

    graph = multiway_register(
        [ds[i] for i in range(len(ds))], register_fn,
        loop_closure_window=args.loop_window)
    traj = [((i, i, len(graph.nodes)), pose)
            for i, pose in enumerate(graph.nodes)]
    write_trajectory(args.out, traj)
    print(f"trajectory written to {args.out}")

    ate = None
    gt = ds.gt_trajectory()
    if gt is not None and len(gt) >= len(graph.nodes):
        ate = ate_rmse(graph.nodes, gt[: len(graph.nodes)], device=device)
        print(f"ATE RMSE: {ate:.4f} m")
    return {"poses": graph.nodes, "ate": ate}


if __name__ == "__main__":
    main()
