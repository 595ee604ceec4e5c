"""Sparse convolution for the DGR engine (MinkowskiEngine's role).

Counterpart of ``gmf_tpu/sparse``:
- ``voxelize.py``  : host quantization (== ME.sparse_quantize), NumPy.
- ``kernel_map.py``: host kernel maps, a dense [K, M] neighbour table a
  level, built by the native C++ builder (NumPy as its plain version),
  hypercube or hypercross offsets.
- ``device_maps.py``: the same maps built on the device (sorted packed
  keys, one exact probe), the pyramid's default off the CPU.
- ``compact.py``   : the 6-D maps' compacted two-tier schedules.
- ``conv.py``      : gather-GEMM convolution on dense maps and on
  compacted schedules, masked norms.
- ``resunet.py``   : the FCGF descriptor net and the 6-D GMF inlier net
  (hypercube or hypercross kernels).
- ``simpleunet.py``, ``pyramidnet.py``: the model registry's other FCGF
  backbones (SimpleNet, PyramidNet).
"""
