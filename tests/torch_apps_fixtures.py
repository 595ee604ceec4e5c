"""Checks shared by tests/test_torch_apps.py (the port against gmf_tpu on
the CPU) and tests/test_torch_cuda.py (the card against the CPU) for the
TSDF volume: a voxel whose projection lies within 1e-4 px of a .5 pixel
edge may gather the neighbouring pixel on another device or package
(both round half to even, and the products that place it may differ in
their last bit)."""

import numpy as np


def edge_voxels(centres, poses, K):
    """[n] bool: the voxel centre projects within 1e-4 px of a .5 pixel
    edge in some frame (f64)."""
    near = np.zeros(len(centres), bool)
    for pose in poses:
        w2c = np.linalg.inv(pose)
        cam = centres.astype(np.float64) @ w2c[:3, :3].T + w2c[:3, 3]
        z = np.maximum(cam[:, 2], 1e-6)
        for q in (cam[:, 0] / z * K[0, 0] + K[0, 2],
                  cam[:, 1] / z * K[1, 1] + K[1, 2]):
            near |= np.abs(q - np.floor(q) - 0.5) < 1e-4
    return near


def apart_only_at_edges(a, b, poses, K):
    """Two clouds of voxel centres differ only at edge voxels: every point
    without a counterpart within 1e-4 m in the other cloud is one.
    Returns how many differ."""
    from scipy.spatial import cKDTree

    apart = np.concatenate([x[cKDTree(y).query(x)[0] > 1e-4]
                            for x, y in ((a, b), (b, a))])
    assert edge_voxels(apart, poses, K).all()
    return len(apart)
