"""End-to-end two-cloud registration demo on the port.

Counterpart of ``examples/demo_registration.py`` (reference:
GMF_PointDSC/demo_registration.py): voxel-downsample both clouds, FPFH
descriptors, nearest-neighbour correspondences, PointDSC+GMF, the
transform. As there, neutral grey frames stand in for the images the GMF
model takes when no frames are given.

    python -m gmf_tpu_torch.examples.demo_registration     # synthetic pair
    python -m gmf_tpu_torch.examples.demo_registration --src a.ply \\
        --tgt b.ply [--checkpoint snapshot/model_best] [--voxel 0.05]

It runs on the card unless ``--cpu`` is given, the full-width
``PointDSC()`` unless ``--tiny`` (two layers, 32 channels, k=20);
without ``--checkpoint`` the weights are random. ``--checkpoint`` takes
the port's checkpoint directory or one ``gmf_tpu`` wrote
(``utils/model_io.py::load_pointdsc``), whose settings it reads.
"""

from __future__ import annotations

import argparse

import numpy as np


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src")
    ap.add_argument("--tgt")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--voxel", type=float, default=0.05)
    ap.add_argument("--num-node", type=int, default=1000)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU through the plain versions")
    ap.add_argument("--tiny", action="store_true",
                    help="tiny random model (smoke test)")
    ap.add_argument("--save-trans", default=None,
                    help="write the estimated [4,4] transform to this .npy")
    return ap.parse_args(argv)


def main(argv=None):
    """The demo (module docstring); returns (transform, labels, RE in
    degrees and TE in metres or None without a ground truth)."""
    args = parse_args(argv)

    import torch

    from gmf_tpu_torch.data.correspondence import build_correspondences
    from gmf_tpu_torch.data.ply import read_ply
    from gmf_tpu_torch.eval.registration import PointDSCRegistrar
    from gmf_tpu_torch.geometry.metrics import rotation_error_deg
    from gmf_tpu_torch.models import PointDSC
    from gmf_tpu_torch.ops.fpfh import compute_fpfh
    from gmf_tpu_torch.sparse.voxelize import sparse_quantize
    from gmf_tpu_torch.utils.device import resolve_device

    device = resolve_device("cpu" if args.cpu else None)
    rng = np.random.RandomState(0)
    if args.src and args.tgt:
        xyz0 = read_ply(args.src)["xyz"]
        xyz1 = read_ply(args.tgt)["xyz"]
        T_gt = None
    else:
        print("no inputs given - generating a synthetic pair")
        xyz0 = rng.rand(3000, 3).astype(np.float32)
        ang = 0.5
        R = np.array([[np.cos(ang), -np.sin(ang), 0],
                      [np.sin(ang), np.cos(ang), 0], [0, 0, 1]], np.float32)
        t = np.array([0.3, -0.1, 0.2], np.float32)
        xyz1 = xyz0 @ R.T + t
        T_gt = np.eye(4, dtype=np.float32)
        T_gt[:3, :3], T_gt[:3, 3] = R, t

    # voxel downsample + FPFH descriptors on the device
    def prep(xyz):
        _, sel = sparse_quantize(xyz, args.voxel)
        pts = xyz[sel].astype(np.float32)
        feat = compute_fpfh(torch.from_numpy(pts).to(device)).cpu().numpy()
        return pts, feat

    pts0, feat0 = prep(xyz0)
    pts1, feat1 = prep(xyz1)
    print(f"voxelized: {len(pts0)} / {len(pts1)} points")

    if args.num_node and len(pts0) > args.num_node:
        s = rng.choice(len(pts0), args.num_node, replace=False)
        pts0, feat0 = pts0[s], feat0[s]
    if args.num_node and len(pts1) > args.num_node:
        s = rng.choice(len(pts1), args.num_node, replace=False)
        pts1, feat1 = pts1[s], feat1[s]

    sample = build_correspondences(
        pts0, pts1, feat0, feat1, np.eye(4, dtype=np.float32),
        inlier_threshold=0.10, use_mutual=False)
    if sample is None:
        raise SystemExit(
            "fewer than 10 putative correspondences — clouds too sparse "
            "(try a smaller --voxel)")
    print(f"{len(sample['corr_pos'])} putative correspondences")

    # neutral grey frames when no RGB is available (the GMF model always
    # takes images)
    H, W = (24, 32) if args.tiny else (120, 160)
    sample["p_image"] = np.full((H, W, 3), 0.5, np.float32)
    sample["q_image"] = np.full((H, W, 3), 0.5, np.float32)

    if args.checkpoint:
        from gmf_tpu_torch.utils.model_io import load_pointdsc

        model = load_pointdsc(args.checkpoint, device=device)
    else:
        print("no checkpoint - random weights (geometry-driven mode)")
        model = (PointDSC(num_layers=2, num_channels=32, k=20, device=device)
                 if args.tiny else PointDSC(device=device))

    trans, labels = PointDSCRegistrar(model)(sample)
    print("estimated transform:\n", np.round(trans, 4))
    print(f"predicted inliers: {int(labels.sum())}/{len(labels)}")
    if args.save_trans:
        np.save(args.save_trans, np.asarray(trans))
    re = te = None
    if T_gt is not None:
        re = float(rotation_error_deg(torch.from_numpy(trans[:3, :3]),
                                      torch.from_numpy(T_gt[:3, :3])))
        te = float(np.linalg.norm(trans[:3, 3] - T_gt[:3, 3]))
        print(f"vs ground truth: RE={re:.3f} deg TE={te * 100:.2f} cm "
              f"{'SUCCESS' if re < 15 and te < 0.3 else 'FAIL'}")
    return trans, labels, re, te


if __name__ == "__main__":
    main()
