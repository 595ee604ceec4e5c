"""Maximum clique by the native solver (a ctypes shim).

Counterpart of ``gmf_tpu/utils/max_clique.py`` (GMF_PointDSC/utils/
max_clique.py:14-40, the reference's prebuilt libpmc.so ABI) over
``cpp/pmc/max_clique.cpp``, which the port compiles itself at first use
(``utils/native.py``: g++ into the git-ignored ``ops/build/``, without
OpenMP, so the search runs on one thread). A failed build raises. The
PMC baseline (``eval/baselines.py``) calls ``pmc``;
``max_clique_python`` is a plain greedy search kept for the tests only.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import numpy as np

from gmf_tpu_torch.utils.native import REPO, build_library

SOURCE = REPO / "cpp" / "pmc" / "max_clique.cpp"

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

        so = build_library(SOURCE, "libgmfpmc",
                           "the native maximum-clique solver (PMC)")
        lib = ctypes.cdll.LoadLibrary(str(so))
        lib.max_clique.restype = ctypes.c_int32
        lib.max_clique.argtypes = [
            ctypes.c_int32,
            ndpointer(ctypes.c_int32, flags="C_CONTIGUOUS"),
            ndpointer(ctypes.c_int32, flags="C_CONTIGUOUS"),
            ctypes.c_int32, ctypes.c_int32,
            ndpointer(ctypes.c_int32, flags="C_CONTIGUOUS"),
        ]
        _LIB, _LIB_PATH = lib, so
        return lib


def library_path() -> Path:
    """The built library's path (building it if needed)."""
    _lib()
    return _LIB_PATH


def pmc(ei, ej, nnodes: int, nnedges: int) -> np.ndarray:
    """Maximum clique of the undirected graph of edges (ei[k], ej[k]),
    vertex ids from 0; returns the member ids, as the reference's shim.
    ``nnedges`` is the reference's argument, ``len(ei)`` is used."""
    ei = np.ascontiguousarray(ei, dtype=np.int32)
    ej = np.ascontiguousarray(ej, dtype=np.int32)
    if len(ei) == 0:
        return np.zeros(0, np.int32)
    lib = _lib()
    outsize = max(int(nnodes), 1)
    output = np.zeros(outsize, dtype=np.int32)
    size = lib.max_clique(len(ei), ei, ej, 0, outsize, output)
    return output[:size].copy()


def max_clique_python(adj: np.ndarray) -> np.ndarray:
    """A plain greedy clique (one pass from each of the 64 best-connected
    vertices) of a boolean adjacency matrix: the tests' plain version,
    exact on graphs with one dominant clique, not on adversarial ones."""
    n = adj.shape[0]
    deg = adj.sum(1)
    order = np.argsort(-deg)
    best = []
    for start in order[: min(n, 64)]:
        clique = [start]
        cand = np.where(adj[start])[0]
        for v in cand[np.argsort(-deg[cand])]:
            if all(adj[v, u] for u in clique):
                clique.append(v)
        if len(clique) > len(best):
            best = clique
    return np.asarray(sorted(best), np.int32)
