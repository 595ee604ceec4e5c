"""Host-side voxelization (== MinkowskiEngine.sparse_quantize).

A NumPy copy of ``gmf_tpu/sparse/voxelize.py``, kept here because the
port imports nothing of the JAX package: floor(xyz / voxel_size), keep
the first point of each voxel. The reference voxelizes this way at every
pipeline entry (GMF_DGR core/deep_global_registration.py:157-185).
"""

from __future__ import annotations

import numpy as np


def sparse_quantize(coords: np.ndarray, voxel_size: float = 1.0,
                    return_index: bool = True,
                    return_inverse: bool = False):
    """Quantize float coordinates onto a voxel grid, dropping duplicates.

    Args:
      coords: [N, D] float (or int) coordinates.
      voxel_size: quantization step (1.0 means coords are already integer).

    Returns:
      voxel int32 coords [M, D] in lexicographic order; optionally the
      first-occurrence indices and the inverse map, as ME's flags.
    """
    if voxel_size != 1.0:
        grid = np.floor(coords / voxel_size).astype(np.int32)
    else:
        grid = np.floor(coords).astype(np.int32)
    # Rows packed into one int64 key sort like np.unique(axis=0) rows
    # (same order, same first occurrence) whenever the extents fit 63
    # bits; the row-wise unique stays as the exact fallback.
    uniq = first_idx = inverse = None
    if len(grid):
        lo = grid.min(axis=0).astype(np.int64)
        shifted = grid.astype(np.int64) - lo
        extent = shifted.max(axis=0) + 1
        bits = int(np.sum(np.ceil(np.log2(np.maximum(extent, 2)))))
        if bits < 63:
            key = shifted[:, 0]
            for d in range(1, grid.shape[1]):
                key = key * extent[d] + shifted[:, d]
            _, first_idx, inverse = np.unique(
                key, return_index=True, return_inverse=True)
            uniq = grid[first_idx]
    if uniq is None:
        uniq, first_idx, inverse = np.unique(
            grid, axis=0, return_index=True, return_inverse=True)
    out = [uniq.astype(np.int32)]
    if return_index:
        out.append(first_idx)
    if return_inverse:
        out.append(inverse)
    return tuple(out) if len(out) > 1 else out[0]
