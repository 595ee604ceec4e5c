"""GC-RANSAC rigid registration by the native solver (a ctypes shim).

Counterpart of ``gmf_tpu/utils/gcransac.py``. The reference's GC-RANSAC
baseline calls the external pygcransac wheel
(GMF_PointDSC/baseline_scripts/baseline_3DMatch.py:101-125,
``pygcransac.findRigidTransform``); ``cpp/gcransac/gcransac_rigid.cpp``
is a first-party Graph-Cut RANSAC with the same call, its sampler a
seeded ``std::mt19937`` (deterministic). The port compiles it at first
use (``utils/native.py``); a failed build raises. Host code, on the
CPU: the baseline's pose comes back to the card's harness as NumPy.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from gmf_tpu_torch.utils.native import REPO, build_library

SOURCE = REPO / "cpp" / "gcransac" / "gcransac_rigid.cpp"

_LIB = None
_LIB_PATH = None
_LIB_LOCK = threading.Lock()


def _lib():
    """The solver, built on first use."""
    global _LIB, _LIB_PATH
    with _LIB_LOCK:
        if _LIB is not None:
            return _LIB
        from numpy.ctypeslib import ndpointer

        so = build_library(SOURCE, "libgmfgcransac",
                           "the native GC-RANSAC solver")
        lib = ctypes.cdll.LoadLibrary(str(so))
        lib.gcransac_rigid.restype = ctypes.c_int32
        lib.gcransac_rigid.argtypes = [
            ndpointer(ctypes.c_double, flags="C_CONTIGUOUS"),
            ndpointer(ctypes.c_double, flags="C_CONTIGUOUS"),
            ctypes.c_int32,
            ctypes.c_double, ctypes.c_double, ctypes.c_double,
            ctypes.c_int32, ctypes.c_double, ctypes.c_uint32,
            ndpointer(ctypes.c_double, flags="C_CONTIGUOUS"),
            ndpointer(ctypes.c_uint8, flags="C_CONTIGUOUS"),
        ]
        _LIB, _LIB_PATH = lib, so
        return lib


def library_path() -> Path:
    """The built library's path (building it if needed)."""
    _lib()
    return _LIB_PATH


def native_available() -> bool:
    """True when the native solver is built or builds here (a compiler
    that fails returns False; ``gcransac_rigid`` would raise)."""
    try:
        _lib()
    except (RuntimeError, OSError):
        return False
    return True


def gcransac_rigid(src: np.ndarray, tgt: np.ndarray, threshold: float,
                   conf: float = 0.99999999,
                   spatial_coherence_weight: float = 0.1,
                   max_iters: int = 5000,
                   neighborhood_radius: Optional[float] = None,
                   seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Graph-Cut RANSAC on putative correspondences src[i] <-> tgt[i].

    Returns (pose [4, 4] float32 with tgt ~= R src + t, mask [N] float32);
    the defaults are the reference's pygcransac call (conf 0.99999999,
    spatial coherence 0.1), the neighbourhood radius 4 x threshold.
    """
    src = np.ascontiguousarray(src, np.float64)
    tgt = np.ascontiguousarray(tgt, np.float64)
    n = len(src)
    pose = np.eye(4, dtype=np.float64).reshape(-1).copy()
    mask = np.zeros(max(n, 1), np.uint8)
    if n >= 3:
        if neighborhood_radius is None:
            neighborhood_radius = 4.0 * threshold
        _lib().gcransac_rigid(
            src.reshape(-1), tgt.reshape(-1), n, float(threshold),
            float(conf), float(spatial_coherence_weight), int(max_iters),
            float(neighborhood_radius), np.uint32(seed), pose, mask)
    return (pose.reshape(4, 4).astype(np.float32),
            mask[:n].astype(np.float32))
