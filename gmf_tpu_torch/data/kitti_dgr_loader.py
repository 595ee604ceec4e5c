"""DGR-style KITTI odometry pair loader (raw velodyne + images).

Parity: GMF_DGR dataloader/kitti_loader.py:22-316 —
- velodyne ``.bin`` frames + camera ``.png`` frames per sequence,
- GT transform = odometry poses refined by ICP, cached to disk as .npy
  (:156-182), with the port's ICP on the loader's device,
- ``KITTINMPairDataset``: pairs >= 10 m apart by odometry (:257-316),
- the reference's excluded-pair blacklist (sequence 8, pair 15,58).

Calibration: velodyne->camera extrinsics are read from each sequence's
``calib.txt`` (Tr row), matching pykitti's convention the reference uses.

Counterpart of ``gmf_tpu/data/kitti_dgr_loader.py``.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from gmf_tpu_torch.data.imageio import load_image
from gmf_tpu_torch.data.dgr_loader import get_matching_indices
from gmf_tpu_torch.sparse.voxelize import sparse_quantize

EXCLUDED_PAIRS = {(8, 15, 58)}  # (seq, t0, t1), kitti_loader.py:311-315


def read_velodyne_bin(path: str) -> np.ndarray:
    """KITTI velodyne scan: float32 [N, 4] (x, y, z, reflectance)."""
    scan = np.fromfile(path, dtype=np.float32).reshape(-1, 4)
    return scan[:, :3]


def read_calib(seq_dir: str) -> np.ndarray:
    """velodyne->cam0 4x4 from calib.txt's ``Tr`` row."""
    with open(os.path.join(seq_dir, "calib.txt")) as f:
        for line in f:
            if line.startswith("Tr"):
                vals = [float(x) for x in line.split()[1:]]
                T = np.eye(4)
                T[:3, :4] = np.asarray(vals).reshape(3, 4)
                return T
    raise FileNotFoundError(f"no Tr row in {seq_dir}/calib.txt")


def read_poses(pose_file: str) -> np.ndarray:
    """Odometry GT poses: [T, 4, 4] cam0 poses."""
    rows = np.loadtxt(pose_file).reshape(-1, 3, 4)
    out = np.tile(np.eye(4), (len(rows), 1, 1))
    out[:, :3, :4] = rows
    return out


class KITTINMPairDataset:
    """Non-monotone pairs >= min_dist apart, GT refined by ICP + cached.

    Layout: <root>/sequences/<SS>/velodyne/*.bin + image_2/*.png,
            <root>/poses/<SS>.txt. The GT's ICP runs on ``device`` (the
    card unless "cpu").
    """

    def __init__(self, root: str, sequences: Optional[List[int]] = None,
                 min_dist: float = 10.0, voxel_size: float = 0.3,
                 icp_cache_dir: Optional[str] = None, image_hw=(120, 160),
                 refine_icp: bool = True, device=None):
        from gmf_tpu_torch.utils.device import resolve_device

        self.device = resolve_device(device)
        self.root = root
        self.voxel_size = voxel_size
        self.image_hw = image_hw
        self.refine_icp = refine_icp
        self.icp_cache_dir = icp_cache_dir or os.path.join(root, "icp_cache")
        os.makedirs(self.icp_cache_dir, exist_ok=True)

        self.pairs: List[Tuple[int, int, int]] = []
        self.poses: Dict[int, np.ndarray] = {}
        self.calib: Dict[int, np.ndarray] = {}
        sequences = sequences if sequences is not None else list(range(11))
        for seq in sequences:
            seq_dir = os.path.join(root, "sequences", f"{seq:02d}")
            pose_file = os.path.join(root, "poses", f"{seq:02d}.txt")
            if not (os.path.isdir(seq_dir) and os.path.exists(pose_file)):
                continue
            poses = read_poses(pose_file)
            self.poses[seq] = poses
            self.calib[seq] = read_calib(seq_dir)
            # pairs >= min_dist apart (ref :257-316): greedy forward scan
            t = poses[:, :3, 3]
            i = 0
            while i < len(t) - 1:
                d = np.linalg.norm(t[i + 1:] - t[i], axis=1)
                far = np.where(d >= min_dist)[0]
                if len(far) == 0:
                    break
                j = i + 1 + int(far[0])
                if (seq, i, j) not in EXCLUDED_PAIRS:
                    self.pairs.append((seq, i, j))
                i = j

    def __len__(self):
        return len(self.pairs)

    def _velo_path(self, seq, t):
        return os.path.join(self.root, "sequences", f"{seq:02d}",
                            "velodyne", f"{t:06d}.bin")

    def _image_path(self, seq, t):
        return os.path.join(self.root, "sequences", f"{seq:02d}",
                            "image_2", f"{t:06d}.png")

    def gt_transform(self, seq: int, t0: int, t1: int,
                     xyz0=None, xyz1=None) -> np.ndarray:
        """Odometry-derived velo0->velo1 transform, ICP-refined + cached
        (kitti_loader.py:156-182)."""
        cache = os.path.join(self.icp_cache_dir, f"{seq}_{t0}_{t1}.npy")
        if os.path.exists(cache):
            return np.load(cache)
        Tr = self.calib[seq]
        P0, P1 = self.poses[seq][t0], self.poses[seq][t1]
        # velo->cam -> world(cam0) chain: M maps frame-t0 velo into t1 velo
        M = (np.linalg.inv(Tr) @ np.linalg.inv(P1) @ P0 @ Tr)
        if self.refine_icp and xyz0 is not None and xyz1 is not None:
            import torch

            from gmf_tpu_torch.geometry.icp import icp_refine

            def t(x):
                return torch.as_tensor(np.asarray(x, np.float32),
                                       device=self.device)

            _, s0 = sparse_quantize(xyz0, self.voxel_size)
            _, s1 = sparse_quantize(xyz1, self.voxel_size)
            M = icp_refine(t(xyz0[s0]), t(xyz1[s1]), t(M),
                           max_corr_dist=2 * self.voxel_size,
                           num_iters=20).cpu().numpy()
        np.save(cache, M)
        return M

    def __getitem__(self, idx) -> Dict[str, np.ndarray]:
        seq, t0, t1 = self.pairs[idx]
        xyz0 = read_velodyne_bin(self._velo_path(seq, t0))
        xyz1 = read_velodyne_bin(self._velo_path(seq, t1))
        T_gt = self.gt_transform(seq, t0, t1, xyz0, xyz1).astype(np.float32)

        coords0, sel0 = sparse_quantize(xyz0, self.voxel_size)
        coords1, sel1 = sparse_quantize(xyz1, self.voxel_size)
        p_image = load_image(self._image_path(seq, t0), *self.image_hw)
        q_image = load_image(self._image_path(seq, t1), *self.image_hw)

        pts0 = xyz0[sel0].astype(np.float32)
        pts1 = xyz1[sel1].astype(np.float32)
        matches = get_matching_indices(pts0, pts1, T_gt,
                                       2 * self.voxel_size)
        return {
            "pcd0": pts0, "pcd1": pts1,
            "coords0": coords0, "coords1": coords1,
            "T_gt": T_gt, "correspondences": matches,
            "p_image": p_image, "q_image": q_image,
            "meta": np.asarray([seq, t0, t1]),
        }
