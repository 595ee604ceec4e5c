"""Build the PointDSC KITTI pair-npz dataset from raw KITTI odometry.

Counterpart of ``gmf_tpu/tools/build_kitti_pairs.py``
(GMF_PointDSC/misc/cal_fcgf.py's KITTI writer :94-433, cal_fpfh.py
process_kitti): one npz per pair {xyz0, xyz1, features0, features1,
p_image, q_image, gt_trans} under ``<out>/{descriptor}_{split}/``, the
layout ``data/kitti.py`` reads. Pairs come from the port's
``KITTINMPairDataset`` (its GT refined by ICP on the device); FPFH or
FCGF (conv1 5, KITTI's, on device kernel maps, a port or ``gmf_tpu``
checkpoint) run on
the card unless ``--cpu``.

Usage:
  python -m gmf_tpu_torch.tools.build_kitti_pairs --root /data/kitti \\
      --out /data/kitti_pairs --split train --descriptor fpfh [--cpu]
"""

from __future__ import annotations

import argparse
import os
from typing import List

import numpy as np
import torch

from gmf_tpu_torch.data.kitti_dgr_loader import KITTINMPairDataset
from gmf_tpu_torch.ops.fpfh import compute_fpfh
from gmf_tpu_torch.tools.precompute_descriptors import (fcgf_features,
                                                        load_fcgf)
from gmf_tpu_torch.utils.device import resolve_device


def main(argv=None) -> List[str]:
    """Returns the npz paths written."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", required=True, help="KITTI odometry root")
    ap.add_argument("--out", required=True)
    ap.add_argument("--split", default="train",
                    choices=["train", "val", "test"])
    ap.add_argument("--descriptor", default="fpfh",
                    choices=["fcgf", "fpfh"])
    ap.add_argument("--fcgf-checkpoint", default=None)
    ap.add_argument("--voxel", type=float, default=0.30)
    ap.add_argument("--min-dist", type=float, default=10.0)
    ap.add_argument("--image-hw", type=int, nargs=2, default=(120, 160))
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)

    # the reference's split sequences (misc/split/{split}_kitti.txt)
    split_file = os.path.join(
        os.path.dirname(__file__), "..", "data", "splits",
        f"{args.split}_kitti.txt")
    with open(split_file) as f:
        seqs = [int(s) for s in f.read().split()]

    fcgf = None
    if args.descriptor == "fcgf":
        if not args.fcgf_checkpoint:
            ap.error("--fcgf-checkpoint is required for --descriptor fcgf")
        fcgf = load_fcgf(args.fcgf_checkpoint, 5, device)  # config_Kitti

    ds = KITTINMPairDataset(args.root, sequences=seqs,
                            min_dist=args.min_dist, voxel_size=args.voxel,
                            image_hw=tuple(args.image_hw), device=device)
    out_dir = os.path.join(args.out, f"{args.descriptor}_{args.split}")
    os.makedirs(out_dir, exist_ok=True)
    print(f"{len(ds)} pairs -> {out_dir}")

    def feat(pts, coords):
        if args.descriptor == "fpfh":
            return compute_fpfh(
                torch.as_tensor(pts, device=device),
                normal_radius=2 * args.voxel,
                feature_radius=5 * args.voxel).cpu().numpy()
        return fcgf_features(fcgf, coords)

    written = []
    for i in range(len(ds)):
        pair = ds[i]
        seq, t0, t1 = pair["meta"]
        out_path = os.path.join(out_dir, f"{seq}_{t0}_{t1}.npz")
        if os.path.exists(out_path):
            continue
        np.savez(
            out_path,
            xyz0=pair["pcd0"], xyz1=pair["pcd1"],
            features0=feat(pair["pcd0"], pair["coords0"]),
            features1=feat(pair["pcd1"], pair["coords1"]),
            p_image=pair["p_image"], q_image=pair["q_image"],
            gt_trans=pair["T_gt"])
        written.append(out_path)
        if (i + 1) % 20 == 0:
            print(f"{i + 1}/{len(ds)}")
    print("done")
    return written


if __name__ == "__main__":
    main()
