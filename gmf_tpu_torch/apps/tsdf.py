"""TSDF volume integration: RGBD frames -> fused fragment cloud.

Counterpart of ``gmf_tpu/apps/tsdf.py`` (GMF_DGR util/integration.py:
43-141: the reference integrates RGB-D frames into an Open3D
ScalableTSDFVolume and extracts a fragment point cloud). A dense grid on
the device: each depth frame is projected into the volume, the truncated
signed distance is averaged with weights, and the zero-crossing band is
extracted as points.

The ``tsdf`` and ``weight`` volumes stay on the device across
``integrate`` calls; a frame's update is plain PyTorch in f32 with TF32
off (``utils/device.py``), in ``gmf_tpu``'s order of operations, so that
pixel indices agree except where a projection lies on a .5 edge (both
round half to even). No TPU kernel lies here: ``gmf_tpu`` computes it in
``jnp``. At ``make_fragments``' 256^3 grid each [D, D, D, 3] f32
temporary is 201 MB; a frame's peak is about 1 GB.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from gmf_tpu_torch.utils.device import resolve_device


class TSDFVolume:
    def __init__(self, origin, dims: Tuple[int, int, int],
                 voxel_size: float = 0.02, sdf_trunc: Optional[float] = None,
                 device=None):
        """origin: [3] world coords of voxel (0,0,0); dims: grid shape;
        ``device``: where the volumes live (the card unless "cpu")."""
        self.device = resolve_device(device)
        self.origin = np.asarray(origin, np.float32)
        self.dims = tuple(dims)
        self.voxel_size = float(voxel_size)
        self.sdf_trunc = float(sdf_trunc or 4 * voxel_size)
        self.tsdf = torch.ones(self.dims, dtype=torch.float32,
                               device=self.device)
        self.weight = torch.zeros(self.dims, dtype=torch.float32,
                                  device=self.device)

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

    def integrate(self, depth: np.ndarray, intrinsics: np.ndarray,
                  cam_to_world: np.ndarray, depth_trunc: float = 4.0):
        """Fuse one depth frame ([H, W] meters) into the volume."""
        self.tsdf, self.weight = _integrate(
            self.tsdf, self.weight, self._tensor(depth),
            self._tensor(intrinsics),
            self._tensor(np.linalg.inv(cam_to_world)),
            self._tensor(self.origin), self.voxel_size, self.sdf_trunc,
            depth_trunc)

    def extract_point_cloud(self, band: float = 0.5) -> np.ndarray:
        """Points at voxels near the zero crossing (|tsdf| < band·trunc),
        selected on the device and fetched once."""
        sel = (self.tsdf.abs() < band) & (self.weight > 0)
        idx = torch.nonzero(sel)  # row-major, as np.argwhere
        pts = ((idx.to(torch.float32) + 0.5) * self.voxel_size
               + self._tensor(self.origin))
        return pts.cpu().numpy()


def _integrate(tsdf, weight, depth, K, world_to_cam, origin,
               voxel_size: float, sdf_trunc: float, depth_trunc: float):
    """One frame's weighted TSDF update: (new tsdf, new weight)."""
    D0, D1, D2 = tsdf.shape
    dev = tsdf.device
    ii, jj, kk = torch.meshgrid(
        torch.arange(D0, device=dev), torch.arange(D1, device=dev),
        torch.arange(D2, device=dev), indexing="ij")
    pts = (torch.stack([ii, jj, kk], -1).to(torch.float32) + 0.5) \
        * voxel_size + origin                                  # [D,D,D,3]
    del ii, jj, kk
    cam = pts @ world_to_cam[:3, :3].T + world_to_cam[:3, 3]
    del pts
    z = cam[..., 2]
    zc = torch.clamp(z, min=1e-6)
    u = cam[..., 0] / zc * K[0, 0] + K[0, 2]
    v = cam[..., 1] / zc * K[1, 1] + K[1, 2]
    del cam, zc
    H, W = depth.shape
    ui = torch.clamp(torch.round(u).to(torch.int64), 0, W - 1)
    vi = torch.clamp(torch.round(v).to(torch.int64), 0, H - 1)
    d = depth.reshape(-1)[vi * W + ui]
    del ui, vi
    valid = ((z > 1e-4) & (u >= 0) & (u < W) & (v >= 0) & (v < H)
             & (d > 1e-4) & (d < depth_trunc))
    sdf = d - z
    valid = valid & (sdf > -sdf_trunc)
    tsdf_obs = torch.clamp(sdf / sdf_trunc, -1.0, 1.0)
    w_obs = valid.to(torch.float32)
    new_w = weight + w_obs
    new_t = torch.where(
        new_w > 0,
        (tsdf * weight + tsdf_obs * w_obs) / torch.clamp(new_w, min=1e-6),
        tsdf)
    return new_t, new_w
