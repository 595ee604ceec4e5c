"""Building the port's native host libraries with g++.

The native code in ``cpp/`` (the kernel-map builder, the maximum-clique
solver, the GC-RANSAC solver) is compiled here at first use, never by
``make`` in ``cpp/``: ``g++ -O3`` into the git-ignored
``gmf_tpu_torch/ops/build/``, the library named by a hash of its source
and flags, so that a changed source builds anew and concurrent builders
never load a half-written file (each writes a temporary name and renames
it). No ``-fopenmp``: the card's machine has no OpenMP runtime, and the
sources guard ``omp.h`` with ``#ifdef _OPENMP``. No ``-march=native``:
the library may be built on one machine and loaded on another. A failed
build raises a ``RuntimeError`` naming what failed to build.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
BUILD_DIR = REPO / "gmf_tpu_torch" / "ops" / "build"
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-shared"]


def build_library(source: Path, stem: str, what: str) -> Path:
    """The path of ``source`` compiled into ``BUILD_DIR/<stem>-<hash>.so``,
    built now unless it exists. ``what`` names the library in the error
    of a failed build."""
    source = Path(source)
    text = source.read_bytes()
    tag = hashlib.sha256(text + " ".join(CXX_FLAGS).encode()).hexdigest()
    so = BUILD_DIR / f"{stem}-{tag[:16]}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        r = subprocess.run(
            [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", tmp,
             str(source)], capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(
                f"building {what} from {source} failed (exit "
                f"{r.returncode}):\n{r.stderr}{r.stdout}")
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return so
