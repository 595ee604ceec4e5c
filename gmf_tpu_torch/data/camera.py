"""Camera projection utilities (3DImageMatch dataset building).

Counterpart of ``gmf_tpu/data/camera.py``: NumPy host helpers, the same
code (GMF_PointDSC/utils/uio.py:160-473, the point->pixel projection
helpers ``p2i``, ``carema2pixe``, ``imageOfPoint`` that associate an RGB
frame with each fragment), as vectorized primitives.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def project_points(xyz: np.ndarray, intrinsics: np.ndarray,
                   world_to_cam: Optional[np.ndarray] = None
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Project world points into pixel coordinates.

    Args:
      xyz: [N, 3] points; intrinsics: [3, 3]; world_to_cam: [4, 4].

    Returns (uv [N, 2] float pixels, in_front [N] bool).
    """
    p = xyz
    if world_to_cam is not None:
        p = xyz @ world_to_cam[:3, :3].T + world_to_cam[:3, 3]
    z = p[:, 2]
    in_front = z > 1e-6
    zs = np.where(in_front, z, 1.0)
    u = p[:, 0] / zs * intrinsics[0, 0] + intrinsics[0, 2]
    v = p[:, 1] / zs * intrinsics[1, 1] + intrinsics[1, 2]
    return np.stack([u, v], axis=-1), in_front


def visibility_mask(xyz: np.ndarray, intrinsics: np.ndarray,
                    world_to_cam: np.ndarray, image_hw: Tuple[int, int],
                    depth: Optional[np.ndarray] = None,
                    depth_tol: float = 0.05) -> np.ndarray:
    """Which points are visible in a camera frame (in-bounds, in front,
    optionally not occluded per a depth map)."""
    H, W = image_hw
    uv, in_front = project_points(xyz, intrinsics, world_to_cam)
    u, v = uv[:, 0], uv[:, 1]
    ok = in_front & (u >= 0) & (u < W) & (v >= 0) & (v < H)
    if depth is not None:
        ui = np.clip(np.round(u).astype(int), 0, W - 1)
        vi = np.clip(np.round(v).astype(int), 0, H - 1)
        p = xyz @ world_to_cam[:3, :3].T + world_to_cam[:3, 3]
        d = depth[vi, ui]
        ok &= (d > 0) & (np.abs(p[:, 2] - d) < depth_tol)
    return ok


def best_frame_for_cloud(xyz: np.ndarray, intrinsics: np.ndarray,
                         world_to_cams, image_hw: Tuple[int, int]) -> int:
    """Pick the camera frame that sees the most points (the heuristic the
    3DImageMatch dataset uses to attach one RGB frame per fragment)."""
    best, best_count = 0, -1
    for i, w2c in enumerate(world_to_cams):
        count = int(visibility_mask(xyz, intrinsics, w2c, image_hw).sum())
        if count > best_count:
            best, best_count = i, count
    return best


def colors_for_points(xyz: np.ndarray, image: np.ndarray,
                      intrinsics: np.ndarray,
                      world_to_cam: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Sample per-point RGB from a frame (nearest pixel).

    Returns (colors [N, 3], valid [N])."""
    H, W = image.shape[:2]
    uv, in_front = project_points(xyz, intrinsics, world_to_cam)
    u = np.clip(np.round(uv[:, 0]).astype(int), 0, W - 1)
    v = np.clip(np.round(uv[:, 1]).astype(int), 0, H - 1)
    valid = in_front & (uv[:, 0] >= 0) & (uv[:, 0] < W) \
        & (uv[:, 1] >= 0) & (uv[:, 1] < H)
    return image[v, u], valid
