"""Sparse convolution for the DGR engine (MinkowskiEngine's role).

Counterpart of ``gmf_tpu/sparse``:
- ``voxelize.py``  : host quantization (== ME.sparse_quantize), NumPy.
- ``kernel_map.py``: host kernel maps, a dense [K, M] neighbour table a
  level, built by the native C++ builder (NumPy as its plain version).
- ``conv.py``      : gather-GEMM convolution on those maps, masked norms.
- ``resunet.py``   : the FCGF descriptor net and the 6-D GMF inlier net.

The compacted convolution and the on-device maps (``compact.py``,
``device_maps.py``) are not ported yet (ROADMAP queue 1 items 5.5, 5.6).
"""
