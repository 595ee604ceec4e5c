"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` (all started
together) for ``sm_90a`` and linked into one shared library with a plain
C interface, loaded with ``ctypes``; ``csrc/*.cuh`` holds what several
sources share. Nothing includes PyTorch's headers,
so a cold build takes seconds. The library lands in ``ops/build/``
(git-ignored), named by a hash of the sources, and is built on first use
only: importing this module builds nothing, so the CPU tests import every
module without a compiler.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; ``check`` raises on a non-zero code. An entry
given an empty shape launches nothing and returns an error, so wrappers
return empty results before calling it. ``launches`` counts successful
kernel launches per wrapper (``chip_smoke.py`` reads it to show that the
main path went through the kernels).
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-lineinfo"]

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float

# C entry points: name -> argument types (pointers and the stream are
# c_void_p, so ctypes never truncates them to 32 bits)
SIGNATURES = {
    # q, k, v, src, tgt, mask, out, lse, B, N, D, is_bf16, sigma_sq, qscale,
    # stream
    "gmf_compat_flash_attention": [P, P, P, P, P, P, P, P, I, I, I, I, F, F,
                                   P],
    # q, k, v, dout, lse, delta, src, tgt, mask, dk, dv, B, N, D, is_bf16,
    # sigma_sq, qscale, scale, stream
    "gmf_compat_flash_attention_bwd_dkv": [P, P, P, P, P, P, P, P, P, P, P,
                                           I, I, I, I, F, F, F, P],
    # q, k, v, dout, lse, delta, src, tgt, mask, dq, B, N, D, is_bf16,
    # sigma_sq, qscale, scale, stream
    "gmf_compat_flash_attention_bwd_dq": [P, P, P, P, P, P, P, P, P, P, I, I,
                                          I, I, F, F, F, P],
    # q, k, v, src, tgt, mask, out, cache, B, N, D, ld, is_bf16, sigma_sq,
    # qscale, stream
    "gmf_compat_flash_attention_build": [P, P, P, P, P, P, P, P, I, I, I, I,
                                         I, F, F, P],
    # q, k, v, cache, mask, out, lse, B, N, D, ld, is_bf16, cache_type,
    # qscale, stream
    "gmf_compat_flash_attention_cached": [P, P, P, P, P, P, P, I, I, I, I, I,
                                          I, F, P],
    # q, k, v, dout, lse, delta, cache, mask, dk, dv, B, N, D, ld, is_bf16,
    # cache_type, qscale, scale, stream
    "gmf_compat_flash_attention_cached_bwd_dkv": [P, P, P, P, P, P, P, P, P,
                                                  P, I, I, I, I, I, I, F, F,
                                                  P],
    # q, k, v, dout, lse, delta, cache, mask, dq, B, N, D, ld, is_bf16,
    # cache_type, qscale, scale, stream
    "gmf_compat_flash_attention_cached_bwd_dq": [P, P, P, P, P, P, P, P, P,
                                                 I, I, I, I, I, I, F, F, P],
    # q, k, v, src, tgt, mask, out, B, N, D, variant, is_bf16, sigma_sq,
    # qscale, stream
    "gmf_compat_flash_variant": [P, P, P, P, P, P, P, I, I, I, I, I, F, F,
                                 P],
    # src, tgt, cache, B, N, ld, cache_type, sigma_sq, stream
    "gmf_build_compat_cache": [P, P, P, I, I, I, I, F, P],
    # feats, src_knn, tgt_knn, sigma, out, n_seeds, k, C, is_bf16,
    # sigma_d_sq, num_iters, stream
    "gmf_fused_seed_weights": [P, P, P, P, P, I, I, I, I, F, I, P],
    # keypts, scores, out, B, N, radius_sq, stream
    "gmf_nms_local_max": [P, P, P, I, I, F, P],
    # seeds, feats, mask, idx, val, B, S, N, C, K, stream
    "gmf_seed_knn_topk": [P, P, P, P, P, I, I, I, I, I, P],
    # trans, src, tgt, mask, counts, B, S, N, thr_sq, stream
    "gmf_seed_hypothesis_counts": [P, P, P, P, P, I, I, I, F, P],
}

launches: collections.Counter = collections.Counter()
_lib = None


def reset_launches():
    launches.clear()


def sources():
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the port's "
                           "kernels are built from ops/csrc on first use")
    return found


def library_path() -> Path:
    h = hashlib.sha256()
    for src in sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libgmf_kernels_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Path:
    """Compile the kernels (one nvcc per source, in parallel), link one
    library, and return its path. A no-op when it is already built."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tmp = Path(tempfile.mkdtemp(prefix="objs_", dir=BUILD_DIR))
    procs = []
    for src in sources():
        obj = tmp / (src.stem + ".o")
        cmd = [nvcc, *ARCH_FLAGS, *NVCC_FLAGS,
               *(["-Xptxas", "-v"] if verbose else []),
               "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for src, _, p in procs:
        log, _ = p.communicate()
        if verbose and log:
            print(log, flush=True)
        if p.returncode != 0:
            failed.append(f"{src.name}:\n{log}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    staged = tmp / out.name
    subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(staged),
                    *[str(o) for _, o, _ in procs]],
                   check=True, capture_output=True, text=True)
    os.replace(staged, out)  # atomic: a concurrent build never sees half
    shutil.rmtree(tmp, ignore_errors=True)
    return out


def load():
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(code: int, name: str):
    """Raise if a C entry point reported a CUDA error; count the launch
    otherwise."""
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code} at launch")
    launches[name] += 1


def stream_of(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream

