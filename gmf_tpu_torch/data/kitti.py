"""KITTI odometry pair dataset (one precomputed npz per pair), host NumPy.

Counterpart of ``gmf_tpu/data/kitti.py`` (reference:
GMF_PointDSC/datasets/KITTI.py:8-157), with the same draws in the same
order: each file of ``{root}/{descriptor}_{split}/`` holds one pair,
{xyz0, xyz1, features0, features1, p_image, q_image, gt_trans}; inlier
threshold 0.60 for training, train-time jitter 0.05.

As the reference: a frame that needs a resize comes back as float32 of
its codes when it was stored as uint8 (``process_image`` keeps uint8's
scale), and in [0, 1] when it already has the model's size.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from gmf_tpu_torch.data.correspondence import build_correspondences
from gmf_tpu_torch.data.imageio import process_image
from gmf_tpu_torch.data.threedmatch import transform_points
from gmf_tpu_torch.geometry.se3 import (random_rotation_matrix,
                                        random_translation)


def _unit_rows(feat):
    return feat / (np.linalg.norm(feat, axis=1, keepdims=True) + 1e-6)


class KITTIDataset:
    def __init__(self, root: str, split: str = "train",
                 descriptor: str = "fcgf", in_dim: int = 6,
                 inlier_threshold: float = 0.60, num_node=5000,
                 use_mutual: bool = True, augment_axis: int = 0,
                 augment_rotation: float = 1.0,
                 augment_translation: float = 0.01,
                 image_hw=(120, 160), device_match: bool = False):
        if descriptor not in ("fcgf", "fpfh"):
            raise ValueError(f"unknown descriptor {descriptor!r}")
        self.root, self.split, self.descriptor = root, split, descriptor
        self.in_dim, self.inlier_threshold = in_dim, inlier_threshold
        self.num_node, self.use_mutual = num_node, use_mutual
        self.augment_axis = augment_axis
        self.augment_rotation = augment_rotation
        self.augment_translation = augment_translation
        self.image_hw, self.device_match = image_hw, device_match
        d = os.path.join(root, f"{descriptor}_{split}")
        self.ids_list = [os.path.join(d, f) for f in sorted(os.listdir(d))]

    def __len__(self):
        return len(self.ids_list)

    def _prep_image(self, img):
        H, W = self.image_hw
        if img.shape[0] != H or img.shape[1] != W:
            img = process_image(img, H, W)
        if img.dtype == np.uint8:
            img = img.astype(np.float32) / 255.0
        return img.astype(np.float32)

    def __getitem__(self, index) -> Dict[str, np.ndarray]:
        data = np.load(self.ids_list[index])
        src_keypts = data["xyz0"].astype(np.float32)
        tgt_keypts = data["xyz1"].astype(np.float32)
        src_feat = data["features0"].astype(np.float32)
        tgt_feat = data["features1"].astype(np.float32)
        p_image = self._prep_image(data["p_image"])
        q_image = self._prep_image(data["q_image"])
        if self.descriptor == "fpfh":
            src_feat, tgt_feat = _unit_rows(src_feat), _unit_rows(tgt_feat)

        orig_trans = data["gt_trans"].astype(np.float64)
        if self.split == "train":
            src_keypts = src_keypts + np.random.rand(len(src_keypts), 3) * 0.05
            tgt_keypts = tgt_keypts + np.random.rand(len(tgt_keypts), 3) * 0.05
        aug = np.eye(4)
        aug[:3, :3] = random_rotation_matrix(self.augment_axis,
                                             self.augment_rotation)
        aug[:3, 3:4] = random_translation(self.augment_translation)
        tgt_keypts = transform_points(tgt_keypts, aug)
        gt_trans = (aug @ orig_trans).astype(np.float32)

        if self.num_node != "all" and len(src_keypts) > self.num_node:
            sel = np.random.choice(len(src_keypts), self.num_node,
                                   replace=False)
            src_keypts, src_feat = src_keypts[sel], src_feat[sel]
        if self.num_node != "all" and len(tgt_keypts) > self.num_node:
            sel = np.random.choice(len(tgt_keypts), self.num_node,
                                   replace=False)
            tgt_keypts, tgt_feat = tgt_keypts[sel], tgt_feat[sel]

        if self.device_match:
            # raw descriptors: matching runs on the card in the registrar
            sample = {
                "src_keypts": src_keypts.astype(np.float32),
                "tgt_keypts": tgt_keypts.astype(np.float32),
                "src_desc": src_feat.astype(np.float32),
                "tgt_desc": tgt_feat.astype(np.float32),
            }
        else:
            sample = build_correspondences(
                src_keypts, tgt_keypts, src_feat, tgt_feat, gt_trans,
                self.inlier_threshold, self.use_mutual, self.in_dim)
            if sample is None:
                return self[int(np.random.choice(len(self)))]
        sample["gt_trans"] = gt_trans
        sample["p_image"] = p_image
        sample["q_image"] = q_image
        return sample
