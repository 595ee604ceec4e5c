"""DGR-style pair loaders: raw clouds + images + GT correspondences.

Parity targets:
- GMF_DGR dataloader/threedmatch_loader.py:24-189 (IndoorPairDataset):
  .ply pair + image pair, random scale [0.8, 1.2] + per-cloud random
  rotation, voxelize, GT matches by radius search, feats = ones.
- util/pointcloud.py:83-96 (get_matching_indices: radius search of warped
  source against target).
- core/correspondence.py:14-53 (find_correct_correspondence: hash-match
  candidate pairs against GT pairs).

Counterpart of ``gmf_tpu/data/dgr_loader.py``: host-side NumPy/SciPy
(data prep), with the same draws from the same generators.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, List, Tuple

import numpy as np

from gmf_tpu_torch.data.imageio import load_image
from gmf_tpu_torch.data.ply import read_ply
from gmf_tpu_torch.geometry.se3 import random_rotation_matrix
from gmf_tpu_torch.sparse.voxelize import sparse_quantize


def get_matching_indices(source: np.ndarray, target: np.ndarray,
                         trans: np.ndarray, search_radius: float
                         ) -> np.ndarray:
    """GT correspondence pairs: warped-source points within radius of a
    target point (all matches, not just 1-NN).

    Parity: GMF_DGR util/pointcloud.py:83-96.
    """
    from scipy.spatial import cKDTree

    warped = source @ trans[:3, :3].T + trans[:3, 3]
    tree = cKDTree(target)
    pairs: List[Tuple[int, int]] = []
    for i, nbrs in enumerate(tree.query_ball_point(warped, search_radius)):
        for j in nbrs:
            pairs.append((i, j))
    return np.asarray(pairs, np.int64).reshape(-1, 2)


def compute_overlap_ratio(pcd0: np.ndarray, pcd1: np.ndarray,
                          trans: np.ndarray, voxel_size: float) -> float:
    """Fraction of points with a match within voxel_size, symmetric min.

    Parity: GMF_DGR util/pointcloud.py:72-80.
    """
    m01 = get_matching_indices(pcd0, pcd1, trans, voxel_size)
    m10 = get_matching_indices(pcd1, pcd0,
                               np.linalg.inv(trans), voxel_size)
    r01 = len(np.unique(m01[:, 0])) / max(len(pcd0), 1)
    r10 = len(np.unique(m10[:, 0])) / max(len(pcd1), 1)
    return min(r01, r10)


def feature_hit_ratio(F0: np.ndarray, F1: np.ndarray, pcd0: np.ndarray,
                      pcd1: np.ndarray, trans: np.ndarray,
                      thresh: float, device=None) -> float:
    """Fraction of 1-NN feature matches that are geometrically correct,
    the 1-NN on ``device`` (the card unless "cpu").

    Parity: GMF_DGR util/pointcloud.py:99-130 (valid_feat_ratio /
    evaluate_feature_3dmatch).
    """
    import torch

    from gmf_tpu_torch.geometry.knn import nearest_neighbor
    from gmf_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    nn01, _ = nearest_neighbor(
        torch.as_tensor(np.asarray(F0), dtype=torch.float32, device=dev),
        torch.as_tensor(np.asarray(F1), dtype=torch.float32, device=dev),
        chunk=1024)
    warped = pcd0 @ trans[:3, :3].T + trans[:3, 3]
    d = np.linalg.norm(warped - pcd1[nn01.cpu().numpy()], axis=1)
    return float((d < thresh).mean())


def hash_pairs(pairs: np.ndarray, hash_seed: int) -> np.ndarray:
    """int64 pair hash i * seed + j (core/correspondence.py:14-27)."""
    return pairs[:, 0].astype(np.int64) * hash_seed + pairs[:, 1]


def find_correct_correspondence(pos_pairs: np.ndarray, pred_pairs: np.ndarray,
                                hash_seed: int) -> np.ndarray:
    """Boolean mask over pred_pairs that appear in pos_pairs.

    Parity: core/correspondence.py:29-53.
    """
    if len(pos_pairs) == 0 or len(pred_pairs) == 0:
        return np.zeros(len(pred_pairs), bool)
    return np.isin(hash_pairs(pred_pairs, hash_seed),
                   hash_pairs(pos_pairs, hash_seed))


def heightfield(rng: np.random.RandomState, n_points: int) -> np.ndarray:
    """[n, 3] float32 points of a bumpy heightfield over the unit square
    (make_dgr_pair's surface)."""
    xy = rng.rand(n_points, 2).astype(np.float32)
    z = (0.15 * np.sin(6 * xy[:, 0]) * np.cos(5 * xy[:, 1])
         + 0.08 * np.sin(13 * xy[:, 0] + 1.0)).astype(np.float32)
    return np.concatenate([xy, z[:, None]], 1)


def make_dgr_pair(rng: np.random.RandomState, n_points: int = 500,
                  voxel_size: float = 0.05, overlap: float = 0.7,
                  image_hw=(16, 16), matching_radius_mult: float = 2.0,
                  random_scale: bool = False,
                  surface: bool = False,
                  outlier_bias: float = 0.0,
                  outlier_scatter: float = 0.0) -> Dict[str, np.ndarray]:
    """Synthetic DGR pair (the loaders' dict), gmf_tpu's draws in order.

    surface=True samples a bumpy heightfield instead of a uniform box,
    the geometry FPFH needs for meaningful normals and histograms.
    outlier_bias > 0 moves cloud 1's points without a partner in cloud 0
    by a constant offset of that length (biased matches, locally
    rigid-consistent); outlier_scatter > 0 adds per-point scatter to it,
    which keeps that cluster locally incoherent, the signal the 6-D inlier
    convolution is built to detect.
    """
    if surface:
        base = heightfield(rng, n_points)
    else:
        base = rng.rand(n_points, 3).astype(np.float32)
    n_keep = int(n_points * overlap)
    keep0 = rng.choice(n_points, n_keep, replace=False)
    keep1 = rng.choice(n_points, n_keep, replace=False)
    xyz0 = base[keep0]
    R = random_rotation_matrix(3, 0.3, rng).astype(np.float32)
    t = (rng.rand(3) * 0.3).astype(np.float32)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3], T[:3, 3] = R, t
    xyz1 = base[keep1] @ R.T + t + 0.002 * rng.randn(n_keep, 3).astype(np.float32)
    if outlier_bias > 0.0:
        lonely = ~np.isin(keep1, keep0)
        direction = np.array([0.8, 0.55, 0.25], np.float32)
        direction /= np.linalg.norm(direction)
        disp = (outlier_bias * direction)[None, :]
        if outlier_scatter > 0.0:
            disp = disp + outlier_scatter * rng.randn(
                int(lonely.sum()), 3).astype(np.float32)
        xyz1[lonely] += disp.astype(np.float32)

    coords0, sel0 = sparse_quantize(xyz0, voxel_size)
    coords1, sel1 = sparse_quantize(xyz1, voxel_size)
    pts0, pts1 = xyz0[sel0], xyz1[sel1]
    matches = get_matching_indices(pts0, pts1, T,
                                   matching_radius_mult * voxel_size)
    H, W = image_hw
    return {
        "pcd0": pts0, "pcd1": pts1,
        "coords0": coords0, "coords1": coords1,
        "T_gt": T, "correspondences": matches,
        "p_image": rng.rand(H, W, 3).astype(np.float32),
        "q_image": rng.rand(H, W, 3).astype(np.float32),
    }


class ThreeDMatchPairDataset:
    """Train pairs from overlap txt files of .ply fragments + RGB frames.

    Parity: GMF_DGR dataloader/threedmatch_loader.py:24-189.
    """

    OVERLAP_RATIO = 0.3

    def __init__(self, root: str, split_file: str, voxel_size: float = 0.05,
                 matching_search_voxel_mult: float = 1.5,
                 random_scale: bool = False, min_scale: float = 0.8,
                 max_scale: float = 1.2, random_rotation: bool = True,
                 rotation_range: float = 360.0, image_hw=(120, 160)):
        self.__dict__.update(locals())
        subset_names = open(split_file).read().split()
        self.files: List[Tuple[str, str]] = []
        for name in subset_names:
            pattern = os.path.join(root, f"{name}*{self.OVERLAP_RATIO:.2f}.txt")
            for fname in glob.glob(pattern):
                with open(fname) as f:
                    for line in f:
                        parts = line.strip().split()
                        if len(parts) >= 2:
                            self.files.append((parts[0], parts[1]))

    def __len__(self):
        return len(self.files)

    def __getitem__(self, idx) -> Dict[str, np.ndarray]:
        rng = np.random
        f0, f1 = self.files[idx]
        xyz0 = read_ply(os.path.join(self.root, f0))["xyz"]
        xyz1 = read_ply(os.path.join(self.root, f1))["xyz"]
        p_image = load_image(
            os.path.join(self.root, f0.replace(".ply", "_0.png")),
            *self.image_hw)
        q_image = load_image(
            os.path.join(self.root, f1.replace(".ply", "_0.png")),
            *self.image_hw)

        # random scale (ref :117-124)
        if self.random_scale and rng.rand() < 0.95:
            scale = (self.min_scale
                     + (self.max_scale - self.min_scale) * rng.rand())
            xyz0, xyz1 = xyz0 * scale, xyz1 * scale

        # per-cloud random rotation (ref :126-132): T_gt relates the two
        T0 = np.eye(4, dtype=np.float32)
        T1 = np.eye(4, dtype=np.float32)
        if self.random_rotation:
            T0[:3, :3] = random_rotation_matrix(
                3, self.rotation_range / 360.0, rng)
            T1[:3, :3] = random_rotation_matrix(
                3, self.rotation_range / 360.0, rng)
            xyz0 = xyz0 @ T0[:3, :3].T
            xyz1 = xyz1 @ T1[:3, :3].T
        T_gt = (T1 @ np.linalg.inv(T0)).astype(np.float32)

        coords0, sel0 = sparse_quantize(xyz0, self.voxel_size)
        coords1, sel1 = sparse_quantize(xyz1, self.voxel_size)
        pts0, pts1 = xyz0[sel0].astype(np.float32), xyz1[sel1].astype(np.float32)
        radius = self.matching_search_voxel_mult * self.voxel_size
        matches = get_matching_indices(pts0, pts1, T_gt, radius)

        return {
            "pcd0": pts0, "pcd1": pts1,
            "coords0": coords0, "coords1": coords1,
            "T_gt": T_gt, "correspondences": matches,
            "p_image": p_image, "q_image": q_image,
        }
