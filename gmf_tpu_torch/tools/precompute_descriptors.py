"""Precompute per-cloud descriptors to the ``*_{fcgf,fpfh}.npz`` format.

Counterpart of ``gmf_tpu/tools/precompute_descriptors.py``
(GMF_PointDSC/misc/cal_fcgf.py extract_features :17-92 + dataset writers,
misc/cal_fpfh.py): voxelize each .ply, run the descriptor backend on the
device (the card unless ``--cpu``), save {xyz, feature} npz next to the
cloud so that the PointDSC loaders (``data/threedmatch.py``) read them.
FPFH is ``ops/fpfh.compute_fpfh``; FCGF is the port's ``FCGFNet`` (conv1
7, 3DMatch's) on kernel maps built on the device
(``sparse/device_maps.py``) with a port or ``gmf_tpu`` checkpoint.

Usage:
  python -m gmf_tpu_torch.tools.precompute_descriptors --root /data/3dmatch \\
      --descriptor fpfh [--voxel 0.05] [--cpu]
  python -m gmf_tpu_torch.tools.precompute_descriptors --root ... \\
      --descriptor fcgf --checkpoint fcgf_ckpt_dir
"""

from __future__ import annotations

import argparse
import glob
import os
from typing import List

import numpy as np
import torch

from gmf_tpu_torch.data.ply import read_ply
from gmf_tpu_torch.ops.fpfh import compute_fpfh
from gmf_tpu_torch.sparse.device_maps import build_pyramid_arrays_device
from gmf_tpu_torch.sparse.resunet import FCGFNet
from gmf_tpu_torch.sparse.voxelize import sparse_quantize
from gmf_tpu_torch.utils.device import resolve_device
from gmf_tpu_torch.utils.model_io import load_state


def extract_fpfh(xyz: np.ndarray, voxel_size: float, device=None):
    """(voxelized points, their FPFH [n, 33]) with radii 2 and 5 voxels."""
    dev = resolve_device(device)
    _, sel = sparse_quantize(xyz, voxel_size)
    pts = xyz[sel].astype(np.float32)
    feat = compute_fpfh(torch.as_tensor(pts, device=dev),
                        normal_radius=2 * voxel_size,
                        feature_radius=5 * voxel_size).cpu().numpy()
    return pts, feat


def load_fcgf(path: str, conv1_kernel_size: int, device=None):
    """An FCGF checkpoint, the port's or ``gmf_tpu``'s
    (``utils/model_io.py::load_state``), as an ``FCGFNet`` in eval mode
    on ``device``."""
    state, _ = load_state(path, "sparse")
    model = FCGFNet(conv1_kernel_size=conv1_kernel_size)
    model.load_state_dict(state, strict=True)
    return model.to(resolve_device(device)).eval()


def fcgf_features(model, coords: np.ndarray, granule: int = 4096):
    """The unit FCGF features [len(coords), C] of voxel ``coords``, on
    the model's device and its kernel maps built there."""
    dev = next(model.parameters()).device
    arrays = build_pyramid_arrays_device(
        coords, 4, conv1_kernel_size=model.conv1_kernel_size,
        granule=granule, device=dev)
    with torch.no_grad():
        feats = torch.ones(arrays["mask_0"].shape[0], 1, device=dev)
        return model(feats, arrays)[:len(coords)].cpu().numpy()


def extract_fcgf(xyz: np.ndarray, voxel_size: float, model):
    """FCGF features via the sparse ResUNet (cal_fcgf.extract_features):
    (voxelized points, features)."""
    coords, sel = sparse_quantize(xyz, voxel_size)
    pts = xyz[sel].astype(np.float32)
    return pts, fcgf_features(model, coords)


def main(argv=None) -> List[str]:
    """Returns the npz paths written."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--descriptor", choices=["fcgf", "fpfh"], default="fpfh")
    ap.add_argument("--voxel", type=float, default=0.05)
    ap.add_argument("--checkpoint", default=None,
                    help="FCGF checkpoint dir (required for fcgf)")
    ap.add_argument("--pattern", default="**/*.ply")
    ap.add_argument("--overwrite", action="store_true")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)

    model = None
    if args.descriptor == "fcgf":
        if not args.checkpoint:
            ap.error("--checkpoint is required for --descriptor fcgf")
        model = load_fcgf(args.checkpoint, 7, device)

    files = sorted(glob.glob(os.path.join(args.root, args.pattern),
                             recursive=True))
    print(f"{len(files)} clouds")
    written = []
    for i, f in enumerate(files):
        out_path = f.replace(".ply", f"_{args.descriptor}.npz")
        if os.path.exists(out_path) and not args.overwrite:
            continue
        xyz = read_ply(f)["xyz"]
        if args.descriptor == "fpfh":
            pts, feat = extract_fpfh(xyz, args.voxel, device)
        else:
            pts, feat = extract_fcgf(xyz, args.voxel, model)
        np.savez(out_path, xyz=pts, feature=feat)
        written.append(out_path)
        if (i + 1) % 50 == 0:
            print(f"{i + 1}/{len(files)}")
    print("done")
    return written


if __name__ == "__main__":
    main()
