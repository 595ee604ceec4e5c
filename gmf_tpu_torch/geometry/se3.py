"""SE(3) rigid-transform utilities.

Counterpart of ``gmf_tpu/geometry/se3.py``: same [4, 4] homogeneous
convention, batched over leading dims. Random-augmentation sampling stays
on the host (NumPy) since it only runs inside data generators.
"""

from __future__ import annotations

import numpy as np
import torch


def transform(pts, trans):
    """``R @ p + t`` for pts [..., N, 3] and trans [..., 4, 4]."""
    R = trans[..., :3, :3]
    t = trans[..., :3, 3]
    return torch.matmul(pts, R.transpose(-1, -2)) + t[..., None, :]


def integrate_trans(R, t):
    """Assemble [..., 4, 4] from R [..., 3, 3] and t [..., 3] (or
    [..., 3, 1] / [..., 1, 3])."""
    t = t.reshape(R.shape[:-2] + (3,))
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=R.dtype,
                          device=R.device).expand(R.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def decompose_trans(trans):
    """Split [..., 4, 4] into (R [..., 3, 3], t [..., 3, 1])."""
    return trans[..., :3, :3], trans[..., :3, 3:4]


def concatenate(trans1, trans2):
    """Compose two SE(3) transforms, ``trans1 o trans2`` ([..., 4, 4])."""
    return torch.matmul(trans1, trans2)


def inverse(trans):
    """Closed-form SE(3) inverse (R^T, -R^T t) of [..., 4, 4]."""
    R, t = decompose_trans(trans)
    Rt = R.transpose(-1, -2)
    return integrate_trans(Rt, -torch.matmul(Rt, t))


def random_rotation_matrix(num_axis, augment_rotation, rng=None):
    """Random rotation about 1 or 3 axes scaled by augment_rotation
    (host-side NumPy, same draws as gmf_tpu.geometry.se3)."""
    assert num_axis in (0, 1, 3)
    rng = rng or np.random
    if num_axis == 0:
        return np.eye(3)
    angles = rng.rand(3) * 2 * np.pi * augment_rotation
    cx, sx = np.cos(angles[0]), np.sin(angles[0])
    cy, sy = np.cos(angles[1]), np.sin(angles[1])
    cz, sz = np.cos(angles[2]), np.sin(angles[2])
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    if num_axis == 1:
        return [Rx, Ry, Rz][int(rng.randint(3))]
    return Rx @ Ry @ Rz


def random_translation(augment_translation, rng=None):
    """Random [3, 1] translation in [0, augment_translation)^3."""
    rng = rng or np.random
    return (rng.rand(3) * augment_translation).reshape(3, 1)
