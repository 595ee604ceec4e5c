"""3DMatch / 3DLoMatch datasets (3DImageMatch layout), host NumPy.

Counterpart of ``gmf_tpu/data/threedmatch.py`` (reference:
GMF_PointDSC/datasets/ThreeDMatch.py), with the same draws from
``random`` and ``np.random`` in the same order, so that seeding both
gives the same samples in both packages:

- ``ThreeDMatchTrainVal``: pair lists from per-scene overlap files,
  ``*_fcgf.npz`` / ``*_fpfh.npz`` {xyz, feature} descriptors, an RGB frame
  per cloud (``*_0.png/jpg`` -> 120x160), jitter and a random SE(3)
  augmentation, ``num_node`` random keypoints, descriptor-space NN
  correspondences, labels by distance, another pair when fewer than 10
  matches survive.
- ``ThreeDMatchTest``: per-scene ``gt.log`` (which stores target->source,
  so the pair's transform is its inverse), num_node='all', mutual
  matching; ``device_match`` gives raw-descriptor samples whose matching
  runs on the card in the registrar's call, with fragment keys for its
  ``DeviceFragmentCache`` when no keypoint is subsampled.
- ``ThreeDLoMatchTest``: the pair list of a pickled PREDATOR pair file
  (``3DLoMatch.pkl``).

Samples are dicts for ``min_clip_collate`` / ``pad_to_bucket``.
"""

from __future__ import annotations

import glob
import os
import pickle
import random
from typing import Dict, List, Optional

import numpy as np
import torch

from gmf_tpu_torch.data.correspondence import build_correspondences
from gmf_tpu_torch.data.imageio import load_image
from gmf_tpu_torch.geometry.se3 import (random_rotation_matrix,
                                        random_translation, transform)
from gmf_tpu_torch.utils.lru import cache_host_arrays

SCENE_LIST = [
    "7-scenes-redkitchen",
    "sun3d-home_at-home_at_scan1_2013_jan_1",
    "sun3d-home_md-home_md_scan9_2012_sep_30",
    "sun3d-hotel_uc-scan3",
    "sun3d-hotel_umd-maryland_hotel1",
    "sun3d-hotel_umd-maryland_hotel3",
    "sun3d-mit_76_studyroom-76-1studyroom2",
    "sun3d-mit_lab_hj-lab_hj_tea_nov_2_2012_scan1_erika",
]


def transform_points(pts, trans) -> np.ndarray:
    """``R p + t`` of host points in f32, through the port's transform on
    the CPU (the reference's loaders call its jnp transform, in f32)."""
    return transform(torch.from_numpy(np.asarray(pts, np.float32)),
                     torch.from_numpy(np.asarray(trans, np.float32))).numpy()


def load_gt_log(scene_path: str) -> Dict[str, np.ndarray]:
    """Parse a 3DMatch ``gt.log``: blocks of one header line (i j total)
    and a 4x4 matrix, keyed '<i>_<j>' (reference ThreeDMatch.py:462-476)."""
    out = {}
    with open(os.path.join(scene_path, "gt.log")) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    i = 0
    while i + 4 < len(lines) or (i + 4 == len(lines) and len(lines) >= 5):
        head = lines[i].split()
        out[f"{head[0]}_{head[1]}"] = np.array(
            [[float(x) for x in lines[i + r].split()] for r in range(1, 5)])
        i += 5
    return out


# Every fragment of a 3DMatch scene appears in many pairs (redkitchen: 60
# fragments, 506 pairs), so its npz and image are decoded once into the
# process-wide host cache (utils/lru.py, ``GMF_FRAG_IO_CACHE_MB``). The
# cached arrays are read-only; every consumer copies.

def _load_descriptors(path_base: str, descriptor: str):
    def build():
        data = np.load(f"{path_base}_{descriptor}.npz")
        xyz = data["xyz"].astype(np.float32)
        feat = data["feature"].astype(np.float32)
        if descriptor == "fpfh":
            feat = np.nan_to_num(feat)
            feat = feat / (np.linalg.norm(feat, axis=1, keepdims=True)
                           + 1e-6)
        return xyz, feat

    return cache_host_arrays(("desc", path_base, descriptor), build)


def _load_frame_image(path_base: str, image_hw):
    def build():
        for ext in ("_0.png", "_0.jpg"):
            p = path_base + ext
            if os.path.exists(p):
                return load_image(p, *image_hw)
        raise FileNotFoundError(f"no image for {path_base}")

    return cache_host_arrays(("img", path_base, tuple(image_hw)), build)


def _subsample(keypts, feat, num_node):
    """``num_node`` rows drawn with replacement (the reference's draw)."""
    sel = np.random.choice(len(keypts), num_node)
    return keypts[sel], feat[sel]


class ThreeDMatchTrainVal:
    """Training/validation pairs with augmentation."""

    def __init__(self, root: str, split: str, overlap_path: str,
                 descriptor: str = "fcgf", in_dim: int = 6,
                 inlier_threshold: float = 0.10, num_node=1000,
                 use_mutual: bool = True, augment_axis: int = 3,
                 augment_rotation: float = 1.0,
                 augment_translation: float = 0.5,
                 image_hw=(120, 160),
                 split_file: Optional[str] = None):
        if descriptor not in ("fcgf", "fpfh"):
            raise ValueError(f"unknown descriptor {descriptor!r}")
        self.root, self.descriptor, self.in_dim = root, descriptor, in_dim
        self.inlier_threshold, self.num_node = inlier_threshold, num_node
        self.use_mutual, self.image_hw = use_mutual, image_hw
        self.augment_axis = augment_axis
        self.augment_rotation = augment_rotation
        self.augment_translation = augment_translation
        if split_file is None:
            split_file = os.path.join(
                os.path.dirname(__file__), "splits", f"{split}_3dmatch.txt")
        with open(split_file) as f:
            subset_names = f.read().split()
        self.files: List[List[str]] = []
        for name in subset_names:
            for fname_txt in glob.glob(os.path.join(overlap_path, name + "*")):
                with open(fname_txt) as f:
                    for line in f:
                        parts = line.strip().split()
                        if len(parts) >= 2:
                            self.files.append([parts[0], parts[1]])

    def __len__(self):
        return len(self.files)

    def __getitem__(self, index) -> Dict[str, np.ndarray]:
        src_id, tgt_id = self.files[index]
        if random.random() > 0.5:
            src_id, tgt_id = tgt_id, src_id
        src_base = os.path.join(self.root, src_id.replace(".ply", ""))
        tgt_base = os.path.join(self.root, tgt_id.replace(".ply", ""))
        src_keypts, src_feat = _load_descriptors(src_base, self.descriptor)
        tgt_keypts, tgt_feat = _load_descriptors(tgt_base, self.descriptor)
        p_image = _load_frame_image(src_base, self.image_hw)
        q_image = _load_frame_image(tgt_base, self.image_hw)

        # jitter and a random SE(3) augmentation (ThreeDMatch.py:136-147)
        src_keypts = src_keypts + np.random.rand(len(src_keypts), 3) * 0.005
        tgt_keypts = tgt_keypts + np.random.rand(len(tgt_keypts), 3) * 0.005
        aug_trans = np.eye(4)
        aug_trans[:3, :3] = random_rotation_matrix(self.augment_axis,
                                                   self.augment_rotation)
        aug_trans[:3, 3:4] = random_translation(self.augment_translation)
        tgt_keypts = transform_points(tgt_keypts, aug_trans)
        gt_trans = aug_trans.astype(np.float32)

        if self.num_node != "all":
            src_keypts, src_feat = _subsample(src_keypts, src_feat,
                                              self.num_node)
            tgt_keypts, tgt_feat = _subsample(tgt_keypts, tgt_feat,
                                              self.num_node)

        sample = build_correspondences(
            src_keypts.astype(np.float32), tgt_keypts, src_feat, tgt_feat,
            gt_trans, self.inlier_threshold, self.use_mutual, self.in_dim)
        if sample is None:  # too few matches: another pair (ref :175-177)
            return self[int(np.random.choice(len(self)))]
        sample["gt_trans"] = gt_trans
        sample["p_image"] = p_image
        sample["q_image"] = q_image
        return sample


def _raw_sample(src_keypts, tgt_keypts, src_feat, tgt_feat):
    """A raw-descriptor sample: matching runs on the card in the
    registrar's call. ``np.asarray`` is a free view of the cached f32
    arrays, which a fragment-cache hit never reads."""
    return {
        "src_keypts": np.asarray(src_keypts, np.float32),
        "tgt_keypts": np.asarray(tgt_keypts, np.float32),
        "src_desc": np.asarray(src_feat, np.float32),
        "tgt_desc": np.asarray(tgt_feat, np.float32),
    }


class ThreeDMatchTest:
    """Per-scene test pairs from gt.log; num_node='all' by default."""

    def __init__(self, root: str, descriptor: str = "fcgf", in_dim: int = 6,
                 inlier_threshold: float = 0.10, num_node="all",
                 use_mutual: bool = True, select_scene: Optional[str] = None,
                 image_hw=(120, 160), device_match: bool = False):
        if descriptor not in ("fcgf", "fpfh"):
            raise ValueError(f"unknown descriptor {descriptor!r}")
        self.root, self.descriptor, self.in_dim = root, descriptor, in_dim
        self.inlier_threshold, self.num_node = inlier_threshold, num_node
        self.use_mutual, self.image_hw = use_mutual, image_hw
        self.device_match = device_match
        self.scene_list = ([select_scene] if select_scene in SCENE_LIST
                           else list(SCENE_LIST))
        self.gt_trans: Dict[str, np.ndarray] = {}
        for scene in self.scene_list:
            for k, v in load_gt_log(os.path.join(root, scene)).items():
                self.gt_trans[f"{scene}@{k}"] = v
        self.keys = list(self.gt_trans.keys())

    def __len__(self):
        return len(self.keys)

    def __getitem__(self, index) -> Dict[str, np.ndarray]:
        key = self.keys[index]
        scene, pair = key.split("@")
        src_id, tgt_id = pair.split("_")
        base = os.path.join(self.root, scene, "seq-01")
        src_base = os.path.join(base, f"cloud_bin_{src_id}")
        tgt_base = os.path.join(base, f"cloud_bin_{tgt_id}")
        src_keypts, src_feat = _load_descriptors(src_base, self.descriptor)
        tgt_keypts, tgt_feat = _load_descriptors(tgt_base, self.descriptor)
        p_image = _load_frame_image(src_base, self.image_hw)
        q_image = _load_frame_image(tgt_base, self.image_hw)

        # gt.log stores target->source (ThreeDMatch.py:363)
        gt_trans = np.linalg.inv(self.gt_trans[key]).astype(np.float32)

        if self.num_node != "all":
            src_keypts, src_feat = _subsample(src_keypts, src_feat,
                                              self.num_node)
            tgt_keypts, tgt_feat = _subsample(tgt_keypts, tgt_feat,
                                              self.num_node)

        if self.device_match:
            sample = _raw_sample(src_keypts, tgt_keypts, src_feat, tgt_feat)
            if self.num_node == "all":
                # stable fragment identity: the registrar's fragment cache
                # sends each fragment to the card once (a random subsample
                # is pair-specific, so it gets no key)
                sample["src_key"] = src_base
                sample["tgt_key"] = tgt_base
        else:
            src32 = src_keypts.astype(np.float32)
            tgt32 = tgt_keypts.astype(np.float32)
            sample = build_correspondences(
                src32, tgt32, src_feat, tgt_feat, gt_trans,
                self.inlier_threshold, self.use_mutual, self.in_dim)
            if sample is None:
                # test pairs are never skipped: fall back to non-mutual
                sample = build_correspondences(
                    src32, tgt32, src_feat, tgt_feat, gt_trans,
                    self.inlier_threshold, False, self.in_dim)
        sample["gt_trans"] = gt_trans
        sample["p_image"] = p_image
        sample["q_image"] = q_image
        sample["scene"] = scene
        return sample


class ThreeDLoMatchTest(ThreeDMatchTest):
    """Low-overlap benchmark: pairs from a PREDATOR pair file, a pickled
    dict of 'src', 'tgt', 'rot', 'trans' (ThreeDMatch.py:478-580)."""

    def __init__(self, root: str, pair_file: str, num_node=5000,
                 descriptor: str = "fcgf", in_dim: int = 6,
                 inlier_threshold: float = 0.10, use_mutual: bool = True,
                 image_hw=(120, 160), device_match: bool = False):
        self.root, self.descriptor, self.in_dim = root, descriptor, in_dim
        self.inlier_threshold, self.num_node = inlier_threshold, num_node
        self.use_mutual, self.image_hw = use_mutual, image_hw
        self.device_match = device_match
        # the pair file is the benchmark's own (pickle, as the reference
        # ships it): load only files from a trusted source
        with open(pair_file, "rb") as f:
            self.infos = pickle.load(f)
        self.keys = list(range(len(self.infos["rot"])))

    def _resolve(self, p: str) -> str:
        """A pair-file entry's fragment stem. The reference's layout first
        (ThreeDMatch.py:512-524): 'test/<scene>/cloud_bin_<id>.pth' with
        descriptors in '{root}/fragments/<scene>/'; else the path taken
        relative to the root."""
        parts = p.split("/")
        if len(parts) >= 3:
            stem = os.path.join(self.root, "fragments", parts[1],
                                parts[-1].replace(".pth", "")
                                .replace(".ply", ""))
            if os.path.exists(f"{stem}_{self.descriptor}.npz"):
                return stem
        stem = os.path.join(self.root, p)
        return stem.replace(".pth", "").replace(".ply", "")

    def __getitem__(self, index):
        gt_trans = np.eye(4, dtype=np.float32)
        gt_trans[:3, :3] = self.infos["rot"][index]
        gt_trans[:3, 3] = self.infos["trans"][index].reshape(3)
        src_base = self._resolve(self.infos["src"][index])
        tgt_base = self._resolve(self.infos["tgt"][index])
        src_keypts, src_feat = _load_descriptors(src_base, self.descriptor)
        tgt_keypts, tgt_feat = _load_descriptors(tgt_base, self.descriptor)
        p_image = _load_frame_image(src_base, self.image_hw)
        q_image = _load_frame_image(tgt_base, self.image_hw)

        # whether a side was subsampled decides its cache key: a random
        # subset is pair-specific and must not be served to later pairs
        subsampled = False
        if self.num_node != "all" and len(src_keypts) > self.num_node:
            src_keypts, src_feat = _subsample(src_keypts, src_feat,
                                              self.num_node)
            subsampled = True
        if self.num_node != "all" and len(tgt_keypts) > self.num_node:
            tgt_keypts, tgt_feat = _subsample(tgt_keypts, tgt_feat,
                                              self.num_node)
            subsampled = True

        if self.device_match:
            sample = _raw_sample(src_keypts, tgt_keypts, src_feat, tgt_feat)
            if not subsampled:
                sample["src_key"] = src_base
                sample["tgt_key"] = tgt_base
        else:
            sample = build_correspondences(
                src_keypts.astype(np.float32), tgt_keypts.astype(np.float32),
                src_feat, tgt_feat, gt_trans, self.inlier_threshold,
                self.use_mutual, self.in_dim)
        sample["gt_trans"] = gt_trans
        sample["p_image"] = p_image
        sample["q_image"] = q_image
        return sample
