"""Synthetic correspondence problems (host-side NumPy).

Counterpart of ``gmf_tpu/data/synthetic.py``
(``make_correspondence_problem`` and ``SyntheticCorrespondenceLoader``):
the same draws from the same ``RandomState``, so a seed gives the same
batches in both packages. Problems are solvable by construction: a known
SE(3) transform, an inlier ratio, Gaussian noise, uniform outliers.
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np

from gmf_tpu_torch.geometry.se3 import (random_rotation_matrix,
                                        random_translation)


def make_correspondence_problem(
    rng: np.random.RandomState,
    num_corr: int = 1000,
    inlier_ratio: float = 0.5,
    noise: float = 0.005,
    extent: float = 3.0,
    image_hw=(120, 160),
    batch: int = 1,
) -> Dict[str, np.ndarray]:
    """dict(corr_pos [B,N,6], src_keypts, tgt_keypts [B,N,3],
    gt_trans [B,4,4], labels [B,N], p_image, q_image [B,H,W,3])."""
    B, N = batch, num_corr
    H, W = image_hw
    src = rng.rand(B, N, 3).astype(np.float32) * extent
    gt_trans = np.zeros((B, 4, 4), np.float32)
    tgt = np.empty_like(src)
    labels = np.ones((B, N), np.float32)
    for b in range(B):
        R = random_rotation_matrix(3, 1.0, rng).astype(np.float32)
        t = random_translation(1.0, rng).astype(np.float32)
        T = np.eye(4, dtype=np.float32)
        T[:3, :3], T[:3, 3:4] = R, t
        gt_trans[b] = T
        tgt[b] = src[b] @ R.T + t[:, 0] + noise * rng.randn(N, 3)
        n_out = int(N * (1.0 - inlier_ratio))
        if n_out:
            out_idx = rng.choice(N, n_out, replace=False)
            tgt[b, out_idx] = rng.rand(n_out, 3) * extent
            labels[b, out_idx] = 0.0
    corr_pos = np.concatenate(
        [src - src.mean(1, keepdims=True), tgt - tgt.mean(1, keepdims=True)],
        axis=-1,
    ).astype(np.float32)
    p_image = rng.rand(B, H, W, 3).astype(np.float32)
    q_image = rng.rand(B, H, W, 3).astype(np.float32)
    return {
        "corr_pos": corr_pos,
        "src_keypts": src,
        "tgt_keypts": tgt,
        "gt_trans": gt_trans,
        "labels": labels,
        "p_image": p_image,
        "q_image": q_image,
    }


class SyntheticCorrespondenceLoader:
    """Iterable of ``steps_per_epoch`` synthetic batches; every pass starts
    again from ``seed``."""

    def __init__(self, batch_size: int = 4, num_corr: int = 256,
                 steps_per_epoch: int = 4, inlier_ratio: float = 0.5,
                 image_hw=(24, 32), seed: int = 0):
        self.batch_size = batch_size
        self.num_corr = num_corr
        self.steps_per_epoch = steps_per_epoch
        self.inlier_ratio = inlier_ratio
        self.image_hw = image_hw
        self.seed = seed

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        rng = np.random.RandomState(self.seed)
        for _ in range(self.steps_per_epoch):
            yield make_correspondence_problem(
                rng, num_corr=self.num_corr, batch=self.batch_size,
                inlier_ratio=self.inlier_ratio, image_hw=self.image_hw)

    def __len__(self):
        return self.steps_per_epoch
