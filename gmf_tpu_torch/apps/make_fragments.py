"""RGBD sequence -> fragments (the multiway pipeline's entry point).

Counterpart of ``gmf_tpu/apps/make_fragments.py``
(GMF_PointDSC/multiway/make_fragments.py:64-110): split the frame
sequence into n-frames-per-fragment chunks; inside each fragment build a
pose graph from frame-to-frame odometry (odometry edges,
uncertain=False) plus keyframe loop-closure edges (uncertain=True),
optimize it, TSDF-integrate the frames at the optimized poses, and write
the fragment point cloud (PLY) + base pose (npy) for multiway_cli to
consume.

As in ``gmf_tpu``, the reference's Open3D hybrid RGBD odometry
(make_fragments.py:35-62) is depth-map backprojection (NumPy, the same
``RandomState`` draws, so both packages pick the same points) and
point-to-plane ICP on fixed-size clouds: normals and ICP run on the
device (the card unless "cpu"), the pose graph in f64 on the host, the
TSDF volume on the device (``apps/tsdf.py``). Loop closures are ICP
seeded from accumulated odometry.

``seconds``: where a dict is given, each stage adds its seconds under
"odometry" (normals and every frame pair's ICP), "pose_graph", "tsdf"
(the frames' integration) and "extract", the device synchronised at each
stage's ends (``utils/device.py::timed_stage``).

Usage:
  python -m gmf_tpu_torch.apps.make_fragments --depth-dir DEPTH \\
      --out FRAGMENTS [--intrinsics K.npy] [--cpu]
"""

from __future__ import annotations

import argparse
import glob
import os
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from gmf_tpu_torch.apps.multiway import (PoseGraph, PoseGraphEdge,
                                         optimize_pose_graph)
from gmf_tpu_torch.apps.tsdf import TSDFVolume
from gmf_tpu_torch.data.imageio import read_png
from gmf_tpu_torch.data.ply import write_ply
from gmf_tpu_torch.geometry.icp import icp_point_to_plane
from gmf_tpu_torch.ops.fpfh import estimate_normals
from gmf_tpu_torch.utils.device import resolve_device, timed_stage

# the reference's default camera: PrimeSense 525/525/319.5/239.5
PRIMESENSE = np.array([[525.0, 0, 319.5], [0, 525.0, 239.5], [0, 0, 1]],
                      np.float32)


def depth_to_cloud(depth: np.ndarray, intrinsics: np.ndarray,
                   depth_trunc: float = 4.0, num_points: int = 2048,
                   seed: int = 0) -> np.ndarray:
    """Backproject a depth map ([H, W] meters) to a fixed-size camera-frame
    cloud [num_points, 3] (subsampled/repeated so that every frame pair
    runs ICP at one shape)."""
    H, W = depth.shape
    v, u = np.mgrid[0:H, 0:W].astype(np.float32)
    z = np.asarray(depth, np.float32)
    valid = (z > 1e-4) & (z < depth_trunc)
    fx, fy = intrinsics[0, 0], intrinsics[1, 1]
    cx, cy = intrinsics[0, 2], intrinsics[1, 2]
    x = (u - cx) / fx * z
    y = (v - cy) / fy * z
    pts = np.stack([x[valid], y[valid], z[valid]], axis=-1)
    if len(pts) == 0:
        return np.zeros((num_points, 3), np.float32)
    rng = np.random.RandomState(seed)
    idx = rng.choice(len(pts), num_points, replace=len(pts) < num_points)
    return pts[idx].astype(np.float32)


def _normals(cloud: np.ndarray, device, radius: float = 0.15):
    return estimate_normals(torch.as_tensor(cloud, device=device),
                            radius=radius)


def rgbd_odometry(cloud_s: np.ndarray, cloud_t: np.ndarray,
                  init: Optional[np.ndarray] = None,
                  max_corr_dist: float = 0.07,
                  num_iters: int = 30,
                  normals_s=None,
                  normal_radius: float = 0.15,
                  device=None) -> Tuple[bool, np.ndarray]:
    """Estimate T mapping frame-t points into frame-s coordinates
    (the pose-graph edge convention, multiway.PoseGraphEdge).

    Point-to-plane ICP on ``device`` in place of the reference's
    compute_rgbd_odometry hybrid term (make_fragments.py:35-62): the
    right objective for two independent samplings of a smooth depth
    surface. ``normals_s``: the source's normals (array or tensor),
    estimated here when None. Success = a sane fraction of points found
    correspondences under the final transform (checked on the host).
    """
    dev = resolve_device(device)
    T0 = np.eye(4, dtype=np.float32) if init is None else init
    if normals_s is None:
        normals_s = _normals(cloud_s, dev, normal_radius)
    T = icp_point_to_plane(
        torch.as_tensor(cloud_t, device=dev),
        torch.as_tensor(cloud_s, device=dev),
        torch.as_tensor(normals_s, device=dev),
        torch.as_tensor(np.asarray(T0, np.float32), device=dev),
        max_corr_dist=max_corr_dist, num_iters=num_iters).cpu().numpy()
    if not np.all(np.isfinite(T)):
        return False, np.eye(4, dtype=np.float32)
    # overlap check under the estimate
    warped = cloud_t @ T[:3, :3].T + T[:3, 3]
    d2 = ((warped[:, None, :] - cloud_s[None, ::8, :]) ** 2).sum(-1)
    frac = float((d2.min(1) < max_corr_dist ** 2).mean())
    return frac > 0.3, T.astype(np.float64)


def make_posegraph_for_fragment(clouds: Sequence[np.ndarray],
                                n_keyframes_per_n_frame: int = 5,
                                max_corr_dist: float = 0.07, device=None,
                                seconds: Optional[Dict[str, float]] = None
                                ) -> PoseGraph:
    """Odometry chain + keyframe loop closures for one fragment's frames
    (ref make_fragments.py:64-110). Node poses are cam->fragment-base."""
    dev = resolve_device(device)
    n = len(clouds)
    nodes: List[np.ndarray] = [np.eye(4)]
    edges: List[PoseGraphEdge] = []
    with timed_stage(seconds, "odometry", dev):
        normals = [_normals(c, dev) for c in clouds]
        for s in range(n - 1):
            t = s + 1
            ok, T_st = rgbd_odometry(clouds[s], clouds[t],
                                     max_corr_dist=max_corr_dist,
                                     normals_s=normals[s], device=dev)
            # ``ok`` is deliberately ignored for adjacent frames: the
            # reference chains the odometry estimate and records a certain
            # edge regardless of success (make_fragments.py:80-92); only
            # keyframe loop closures below gate on success (:103). The
            # pose-graph optimization recovers from a bad odometry link.
            # X_t = X_s @ T_st (edge maps frame t into frame s)
            nodes.append(nodes[s] @ T_st)
            edges.append(PoseGraphEdge(s, t, T_st, uncertain=False))
        k = max(n_keyframes_per_n_frame, 1)
        for s in range(0, n, k):
            for t in range(s + k, n, k):
                if t == s + 1:
                    continue
                init = np.linalg.inv(nodes[s]) @ nodes[t]  # odometry seed
                ok, T_st = rgbd_odometry(clouds[s], clouds[t], init=init,
                                         max_corr_dist=max_corr_dist,
                                         normals_s=normals[s], device=dev)
                if ok:
                    edges.append(PoseGraphEdge(s, t, T_st, uncertain=True))
    with timed_stage(seconds, "pose_graph", dev):
        return optimize_pose_graph(PoseGraph(nodes=nodes, edges=edges))


def fragment_grid(depths: Sequence[np.ndarray], poses,
                  intrinsics: np.ndarray, voxel_size: float = 0.02,
                  depth_trunc: float = 4.0, margin: float = 0.2,
                  max_dim: int = 256):
    """(lo, hi, dims, capped) of the TSDF grid that ``integrate_fragment``
    fuses these frames into: the box [lo, hi] of 512 points sampled from
    each frame at its pose, widened by ``margin``; its voxels, at most
    ``max_dim`` a side, anchored at lo; whether the cap cut the box."""
    pts_all = []
    for depth, pose in zip(depths, poses):
        c = depth_to_cloud(depth, intrinsics, depth_trunc, num_points=512)
        pts_all.append(c @ np.asarray(pose)[:3, :3].T
                       + np.asarray(pose)[:3, 3])
    pts_all = np.concatenate(pts_all, axis=0)
    lo = pts_all.min(0) - margin
    hi = pts_all.max(0) + margin
    want = np.ceil((hi - lo) / voxel_size).astype(int) + 1
    return lo, hi, np.minimum(want, max_dim), bool(np.any(want > max_dim))


def integrate_fragment(depths: Sequence[np.ndarray], poses,
                       intrinsics: np.ndarray, voxel_size: float = 0.02,
                       depth_trunc: float = 4.0, margin: float = 0.2,
                       max_dim: int = 256, device=None,
                       seconds: Optional[Dict[str, float]] = None
                       ) -> np.ndarray:
    """TSDF-fuse the fragment's frames at their optimized poses on
    ``device`` and extract the fragment cloud (ref
    make_fragments.py:113-131)."""
    dev = resolve_device(device)
    lo, hi, dims, capped = fragment_grid(depths, poses, intrinsics,
                                         voxel_size, depth_trunc, margin,
                                         max_dim)
    if capped:  # no silent caps: the grid anchors at lo
        warnings.warn(
            f"fragment extent {np.round(hi - lo, 2)} m exceeds the "
            f"{max_dim}-voxel TSDF grid ({max_dim * voxel_size:.2f} m "
            "per axis); geometry beyond the grid is not integrated — "
            "raise max_dim or voxel_size", stacklevel=2)
    with timed_stage(seconds, "tsdf", dev):
        vol = TSDFVolume(lo, tuple(int(d) for d in dims),
                         voxel_size=voxel_size, device=dev)
        for depth, pose in zip(depths, poses):
            vol.integrate(depth, intrinsics, np.asarray(pose),
                          depth_trunc=depth_trunc)
    with timed_stage(seconds, "extract", dev):
        return vol.extract_point_cloud()


def make_fragments(depths: Sequence[np.ndarray], intrinsics: np.ndarray,
                   out_dir: str, n_frames_per_fragment: int = 20,
                   n_keyframes_per_n_frame: int = 5,
                   voxel_size: float = 0.02, depth_trunc: float = 4.0,
                   max_corr_dist: float = 0.07, device=None,
                   seconds: Optional[Dict[str, float]] = None) -> List[dict]:
    """The whole pipeline: sequence -> fragments/fragment_%03d.ply (+
    _pose.npy).

    Returns [{xyz, pose, path}] per fragment; the written tree feeds
    multiway_cli (RedwoodDataset fragment layout).
    """
    dev = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    n_files = len(depths)
    n_fragments = -(-n_files // n_frames_per_fragment)
    fragments = []
    for fid in range(n_fragments):
        sid = fid * n_frames_per_fragment
        eid = min(sid + n_frames_per_fragment, n_files)
        frame_depths = [np.asarray(d, np.float32) for d in depths[sid:eid]]
        clouds = [depth_to_cloud(d, intrinsics, depth_trunc, seed=sid + i)
                  for i, d in enumerate(frame_depths)]
        graph = make_posegraph_for_fragment(
            clouds, n_keyframes_per_n_frame, max_corr_dist, device=dev,
            seconds=seconds)
        xyz = integrate_fragment(frame_depths, graph.nodes, intrinsics,
                                 voxel_size, depth_trunc, device=dev,
                                 seconds=seconds)
        path = os.path.join(out_dir, f"fragment_{fid:03d}.ply")
        write_ply(path, xyz.astype(np.float32))
        np.save(path.replace(".ply", "_pose.npy"), graph.nodes[0])
        fragments.append({"xyz": xyz.astype(np.float32),
                          "pose": graph.nodes, "path": path})
    return fragments


def _read_depth(path: str, depth_scale: float) -> np.ndarray:
    """Read one depth frame: .npy (meters) or 16-bit .png (units of
    1/depth_scale meters, the TUM/Redwood convention the reference's
    Open3D read_image consumes), decoded by the port's own PNG reader."""
    if path.endswith(".npy"):
        return np.asarray(np.load(path), np.float32)
    d = read_png(path, raw=True)
    return d.astype(np.float32) / float(depth_scale)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--depth-dir", required=True,
                    help="directory of depth frames (*.png 16-bit or *.npy)")
    ap.add_argument("--out", required=True, help="fragment output directory")
    ap.add_argument("--intrinsics", default=None,
                    help=".npy [3,3] camera matrix (default: primesense "
                         "525/525/319.5/239.5, the reference's default)")
    ap.add_argument("--depth-scale", type=float, default=1000.0,
                    help="png depth units per meter")
    ap.add_argument("--n-frames-per-fragment", type=int, default=20)
    ap.add_argument("--n-keyframes-per-n-frame", type=int, default=5)
    ap.add_argument("--voxel", type=float, default=0.02)
    ap.add_argument("--depth-trunc", type=float, default=4.0)
    ap.add_argument("--max-corr-dist", type=float, default=0.07)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the card)")
    return ap.parse_args(argv)


def main(argv=None) -> List[dict]:
    """CLI parity: GMF_PointDSC/multiway/make_fragments.py __main__ —
    scan a sequence directory for depth frames, emit
    fragments/fragment_%03d.ply (+ _pose.npy) for multiway_cli."""
    args = parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)
    paths = sorted(glob.glob(os.path.join(args.depth_dir, "*.npy"))
                   + glob.glob(os.path.join(args.depth_dir, "*.png")))
    if not paths:
        raise SystemExit(f"no depth frames under {args.depth_dir}")
    depths = [_read_depth(p, args.depth_scale) for p in paths]
    if args.intrinsics:
        K = np.asarray(np.load(args.intrinsics), np.float32)
    else:
        K = PRIMESENSE
    frags = make_fragments(
        depths, K, args.out,
        n_frames_per_fragment=args.n_frames_per_fragment,
        n_keyframes_per_n_frame=args.n_keyframes_per_n_frame,
        voxel_size=args.voxel, depth_trunc=args.depth_trunc,
        max_corr_dist=args.max_corr_dist, device=device)
    print(f"{len(depths)} frames -> {len(frags)} fragments in {args.out}")
    return frags


if __name__ == "__main__":
    main()
