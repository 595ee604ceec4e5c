"""Redwood / Augmented ICL-NUIM datasets.

Counterpart of ``gmf_tpu/data/redwood.py`` (GMF_PointDSC/datasets/
Redwood.py, P9), host NumPy on the port's ``data/ply.py`` and
``data/correspondence.py``:
- ``RedwoodDataset``: per-scene fragment lists feeding the multiway
  pose-graph app (the reference picks the scene interactively when
  unspecified; here it's an argument).
- ``RedwoodPairDataset``: pairwise-registration samples (Redwood.py:9-236)
  — per-fragment npz descriptors + ``fragment_XXX.npy`` world poses,
  gt_trans[i,j] = inv(pose_j) @ pose_i for all i<j, per-pair overlap
  computed from the fragments (cached to ``<scene>-overlap.pkl``, same
  contract as the reference :77-106; the pickle holds a dict of str to
  Python float only, so either package reads the other's) and pairs
  filtered by ``min_overlap``; __getitem__ builds mutual-NN
  correspondences exactly like ThreeDMatch.
"""

from __future__ import annotations

import glob
import os
import pickle
from typing import Dict, List, Optional

import numpy as np

from gmf_tpu_torch.data.correspondence import build_correspondences
from gmf_tpu_torch.data.ply import read_ply

SCENES = ["livingroom1", "livingroom2", "office1", "office2"]
SCENES_SIMULATED = [f"{s}-simulated" for s in SCENES]


class RedwoodDataset:
    """Fragments of one Augmented ICL-NUIM scene.

    Layout: <root>/<scene>/fragments/*.ply (+ optional gt trajectory
    <root>/<scene>/gt.log for ATE evaluation).
    """

    def __init__(self, root: str, scene: Optional[str] = None):
        self.root = root
        if scene is None:
            available = [s for s in SCENES
                         if os.path.isdir(os.path.join(root, s))]
            assert available, f"no Redwood scenes under {root}"
            scene = available[0]
        self.scene = scene
        frag_dir = os.path.join(root, scene, "fragments")
        self.files: List[str] = sorted(glob.glob(
            os.path.join(frag_dir, "*.ply")))
        if not self.files:  # flat layout fallback
            self.files = sorted(glob.glob(os.path.join(root, scene, "*.ply")))

    def __len__(self):
        return len(self.files)

    def __getitem__(self, idx) -> Dict[str, np.ndarray]:
        return {"xyz": read_ply(self.files[idx])["xyz"],
                "path": self.files[idx]}

    def gt_trajectory(self):
        from gmf_tpu_torch.apps.multiway import read_trajectory

        path = os.path.join(self.root, self.scene, "gt.log")
        if os.path.exists(path):
            return [mat for _, mat in read_trajectory(path)]
        return None


def _min_dist_below(a: np.ndarray, b: np.ndarray, tau: float) -> np.ndarray:
    """Per-row-of-a boolean: nearest point in b closer than tau (KD-tree;
    same result as the reference's dense NxN min, Redwood.py:98-101)."""
    from scipy.spatial import cKDTree

    d, _ = cKDTree(b).query(a, k=1)
    return d < tau


class RedwoodPairDataset:
    """Pairwise registration samples over one scene's fragments."""

    def __init__(self, root: str, scene: str, descriptor: str = "fpfh",
                 min_overlap: float = 0.30, in_dim: int = 6,
                 inlier_threshold: float = 0.10, num_node=5000,
                 use_mutual: bool = True, rng: Optional[
                     np.random.RandomState] = None):
        assert descriptor in ("fcgf", "fpfh")
        self.__dict__.update(locals())
        self.rng = rng or np.random.RandomState()
        frag_dir = os.path.join(root, scene, "fragments")
        npzs = sorted(glob.glob(os.path.join(
            frag_dir, f"fragment_*_{descriptor}.npz")))
        assert npzs, f"no fragment_*_{descriptor}.npz under {frag_dir}"
        self.num_pcds = max(
            int(os.path.basename(f).split("_")[1]) for f in npzs) + 1

        # world poses + all-pairs relative GT (Redwood.py:64-74)
        self.gt_trajectory = [
            np.load(os.path.join(frag_dir, f"fragment_{i:03d}.npy"))
            for i in range(self.num_pcds)]
        self.gt_trans: Dict[str, np.ndarray] = {}
        for i in range(self.num_pcds):
            for j in range(i + 1, self.num_pcds):
                self.gt_trans[f"{scene}@{i}_{j}"] = (
                    np.linalg.inv(self.gt_trajectory[j])
                    @ self.gt_trajectory[i])

        # per-pair overlap, cached like the reference (:77-106)
        cache = os.path.join(root, f"{scene}-overlap.pkl")
        if os.path.exists(cache):
            with open(cache, "rb") as f:
                self.gt_overlap = pickle.load(f)
        else:
            self.gt_overlap = {}
            for key, T in self.gt_trans.items():
                i, j = map(int, key.split("@")[1].split("_"))
                src = self._load(i)[0]
                tgt = self._load(j)[0]
                warped = src @ T[:3, :3].T + T[:3, 3]
                l1 = _min_dist_below(warped, tgt, inlier_threshold)
                l2 = _min_dist_below(tgt, warped, inlier_threshold)
                self.gt_overlap[key] = max(float(l1.mean()),
                                           float(l2.mean()))
            with open(cache, "wb") as f:
                pickle.dump(self.gt_overlap, f)

        self.keys = sorted(
            (k for k in self.gt_trans
             if self.gt_overlap.get(k, 1.0) >= min_overlap),
            key=lambda k: tuple(map(int, k.split("@")[1].split("_"))))

    def _load(self, idx: int):
        path = os.path.join(self.root, self.scene, "fragments",
                            f"fragment_{idx:03d}_{self.descriptor}.npz")
        data = np.load(path)
        xyz = data["xyz"].astype(np.float32)
        feat = data["feature"].astype(np.float32)
        if self.descriptor == "fpfh":  # L2-normalize (Redwood.py:137-139)
            feat = feat / (np.linalg.norm(feat, axis=1, keepdims=True)
                           + 1e-6)
        return xyz, feat

    def __len__(self):
        return len(self.keys)

    def __getitem__(self, index) -> Dict[str, np.ndarray]:
        key = self.keys[index]
        i, j = map(int, key.split("@")[1].split("_"))
        src_keypts, src_feat = self._load(i)
        tgt_keypts, tgt_feat = self._load(j)

        if self.num_node != "all" and len(src_keypts) > self.num_node:
            sel = self.rng.choice(len(src_keypts), self.num_node,
                                  replace=False)
            src_keypts, src_feat = src_keypts[sel], src_feat[sel]
        if self.num_node != "all" and len(tgt_keypts) > self.num_node:
            sel = self.rng.choice(len(tgt_keypts), self.num_node,
                                  replace=False)
            tgt_keypts, tgt_feat = tgt_keypts[sel], tgt_feat[sel]

        gt_trans = self.gt_trans[key].astype(np.float32)
        sample = build_correspondences(
            src_keypts, tgt_keypts, src_feat, tgt_feat, gt_trans,
            self.inlier_threshold, self.use_mutual, self.in_dim)
        if sample is None:  # eval pairs are never skipped
            sample = build_correspondences(
                src_keypts, tgt_keypts, src_feat, tgt_feat, gt_trans,
                self.inlier_threshold, False, self.in_dim)
        sample["gt_trans"] = gt_trans
        sample["scene"] = self.scene
        sample["key"] = key
        return sample
