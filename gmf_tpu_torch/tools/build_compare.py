"""What the build-comparison tools share: load another tree's kernel
library beside this one's, time a launch of each in turns on one card, and
list a library's SASS per kernel.

Used by ``scripts/compare_forward_builds.py``,
``gmf_tpu_torch.tools.compare_knn_builds`` and
``gmf_tpu_torch.tools.compare_backward_builds``. Each tree's kernels are
built from its own ``gmf_tpu_torch/ops/csrc`` by its own
``ops/_build.py``; the trees export C entry points of the same names, so
each is called through ctypes on the same tensors, on the current stream.
"""

from __future__ import annotations

import ctypes
import importlib.util
import os
import re
import subprocess
from pathlib import Path


def card() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def load_build(tree: Path, name: str):
    """The ``ops/_build.py`` module of ``tree``, imported under ``name``."""
    spec = importlib.util.spec_from_file_location(
        name, tree / "gmf_tpu_torch" / "ops" / "_build.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def open_lib(build):
    """(ctypes library, path) of a tree's kernels, built if need be, every
    entry point of its ``SIGNATURES`` bound."""
    path = build.build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in build.SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib, path


def call(lib, run):
    """Launch ``run(lib)``; raise on a CUDA error code."""
    code = run(lib)
    if code != 0:
        raise RuntimeError(f"CUDA error {code} at launch")


def time_turns(libs, run, reps: int):
    """Mean ms of ``reps`` launches (CUDA events, after one warm launch) of
    ``libs["base"]`` and ``libs["this"]`` in the order base, this, this,
    base: {"base": [ms, ms], "this": [ms, ms]}."""
    import torch

    times = {"base": [], "this": []}
    for who in ("base", "this", "this", "base"):
        call(libs[who], run)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            call(libs[who], run)
        end.record()
        end.synchronize()
        times[who].append(start.elapsed_time(end) / reps)
    return times


def speedup(times) -> float:
    """base ms over this tree's ms, from the means of both turns."""
    base = sum(times["base"]) / len(times["base"])
    this = sum(times["this"]) / len(times["this"])
    return base / this if this > 0 else float("inf")


def demangle(names) -> list:
    """C++ names as cu++filt (the CUDA toolkit's) prints them."""
    tool = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin"
    out = subprocess.run([str(tool / "cu++filt")], input="\n".join(names),
                         capture_output=True, text=True, check=True).stdout
    return out.splitlines()


def sass(path: Path, demangled: bool = False) -> dict:
    """{kernel name: SASS lines} of a library, with the file hashes in the
    names and the numbers of the compiler's internal subroutines (division,
    sqrt slow paths, numbered per source file) masked, runs of blanks
    collapsed (the listing pads each line to its file's longest
    instruction) and the source paths (``identifier = ...``) left out.
    ``demangled``: the names as C++ declarations (anonymous namespaces
    then carry no hash)."""
    text = subprocess.run(["cuobjdump", "-sass", str(path)], check=True,
                          capture_output=True, text=True).stdout
    masks = ((re.compile(r"_GLOBAL__N__[0-9a-f]{8}_\d+_\w+?_cu_[0-9a-f]{8}"),
              "_GLOBAL_"), (re.compile(r"__internal_\d+_"), "__internal_"))
    funcs, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
            continue
        for pattern, repl in masks:
            line = pattern.sub(repl, line)
        if name is not None and "identifier =" not in line:
            funcs[name].append(" ".join(line.split()))
    names = list(funcs)
    pattern, repl = masks[0]
    keys = (demangle(names) if demangled
            else [pattern.sub(repl, n) for n in names])
    return dict(zip(keys, funcs.values()))


def first_diff(a, b, count=3):
    """The first ``count`` differing line pairs of two SASS listings."""
    pairs = [(x, y) for x, y in zip(a, b) if x != y]
    return dict(lines=(len(a), len(b)), differing=len(pairs),
                first=pairs[:count])
