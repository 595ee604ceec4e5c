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


# -- a synthetic RGB-D room ---------------------------------------------------
#
# Not in gmf_tpu (its tests render a bumpy wall): a room of 6 x 3 x 5.5 m
# (camera axes: x right, y down, z forward) holding boxes and spheres, seen
# by a camera that drifts and turns slowly, as a hand-held Redwood/ICL-NUIM
# sequence does, for the reconstruction apps' checks at full frame size.
ROOM_LO = np.array([-3.0, -1.5, -2.5])
ROOM_HI = np.array([3.0, 1.5, 3.0])
ROOM_BOXES = (((-1.6, 0.6, 1.2), (-0.6, 1.5, 2.2)),
              ((0.4, -0.2, 2.2), (1.4, 1.5, 3.0)),
              ((1.8, 0.9, 0.2), (3.0, 1.5, 1.2)),
              ((-3.0, -0.4, 0.5), (-2.4, 0.6, 1.6)))
ROOM_SPHERES = (((-0.2, 0.9, 1.6), 0.35), ((1.9, -0.4, 2.6), 0.5),
                ((-1.8, -0.9, 2.5), 0.4), ((0.9, 1.1, 0.9), 0.3))


def room_pose(i: int) -> np.ndarray:
    """Camera-to-world pose of frame ``i``: 1.5 cm a frame along x, 0.5 cm
    along z, a yaw of 0.006 rad and a pitch swing of +-0.05 rad."""
    yaw, pitch = 0.006 * i, 0.05 * np.sin(i / 7.0)
    cy, sy, cp, sp = np.cos(yaw), np.sin(yaw), np.cos(pitch), np.sin(pitch)
    R_yaw = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    R_pitch = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
    T = np.eye(4)
    T[:3, :3] = R_yaw @ R_pitch
    T[:3, 3] = [-0.6 + 0.015 * i, 0.0, -0.8 + 0.005 * i]
    return T


def render_room_depth(cam_to_world: np.ndarray, intrinsics: np.ndarray,
                      hw, device="cpu") -> np.ndarray:
    """z-depth [H, W] float32 metres of the room (walls, boxes, spheres)
    from one camera pose, by exact ray casting in f64 on ``device``."""
    import torch

    H, W = hw
    K = intrinsics

    def t64(x):
        return torch.as_tensor(np.asarray(x, np.float64), device=device)

    v, u = torch.meshgrid(torch.arange(H, dtype=torch.float64, device=device),
                          torch.arange(W, dtype=torch.float64, device=device),
                          indexing="ij")
    d = torch.stack([(u - K[0, 2]) / K[0, 0], (v - K[1, 2]) / K[1, 1],
                     torch.ones_like(u)], -1) @ t64(cam_to_world[:3, :3]).T
    o = t64(cam_to_world[:3, 3])
    inv = 1.0 / d  # +-inf along an axis the ray does not move on
    # the room's walls from inside: the nearest exit
    t = torch.where(d > 0, (t64(ROOM_HI) - o) * inv,
                    (t64(ROOM_LO) - o) * inv).amin(-1)
    for lo, hi in ROOM_BOXES:
        t1, t2 = (t64(lo) - o) * inv, (t64(hi) - o) * inv
        near = torch.minimum(t1, t2).amax(-1)
        far = torch.maximum(t1, t2).amin(-1)
        t = torch.where((far >= near) & (near > 0), torch.minimum(t, near), t)
    a = (d * d).sum(-1)
    for c, r in ROOM_SPHERES:
        oc = o - t64(c)
        b = (d * oc).sum(-1)
        disc = b * b - a * ((oc * oc).sum() - r * r)
        hit = (-b - torch.sqrt(torch.clamp(disc, min=0.0))) / a
        t = torch.where((disc > 0) & (hit > 0), torch.minimum(t, hit), t)
    # the camera ray has z = 1: t is the z-depth
    return t.to(torch.float32).cpu().numpy()
