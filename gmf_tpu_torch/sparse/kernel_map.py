"""Host-side kernel-map construction for sparse convolution.

A copy of ``gmf_tpu/sparse/kernel_map.py`` (NumPy, the same bits), kept
here because the port imports nothing of the JAX package. For every
kernel offset k the DENSE neighbour table ``nbr[k, j]`` holds the index
of the input voxel at coord(out_j) + offset_k, or a sentinel (= N_in)
when there is none; empty offsets are pruned in 6-D, where few of the
3^6 = 729 offsets match.

Two builders fill the table, chosen by name, and give the same bits:

- ``"native"`` (the default): ``cpp/kernelmap/kernel_map.cpp``, an
  open-addressing hash over packed int64 keys, compiled with ``g++ -O3``
  into the port's git-ignored ``ops/build/`` at first use (never
  ``make`` in ``cpp/``). It is built without ``-fopenmp`` (the card's
  machine has no OpenMP runtime); instead the offsets are split over
  host threads, each a call into the library (ctypes releases the GIL).
  A failed build, or coordinates whose extent cannot pack into int64,
  raises.
- ``"numpy"``: one batched ``searchsorted`` over all K x M queries, the
  builder's plain version (the tests hold the two against each other).

``BUILDS`` counts the maps each builder made (``chip_smoke.py`` reads it
to show that the main path's maps came from the native builder).

Stride/lattice conventions follow MinkowskiEngine:
- a tensor at stride t has integer coords that are multiples of t;
- a stride-s conv maps to the (s*t)-lattice: out coords =
  floor_div(in, s*t) * s*t, kernel offsets are multiples of t;
- a stride-s transpose conv maps back to given finer coords; pair (j_out
  fine, i_in coarse) exists iff coarse == fine_coord + offset for some
  kernel offset (the exact reversal of the forward map).
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import os
import threading
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

from gmf_tpu_torch.utils.native import build_library

SOURCE = (Path(__file__).resolve().parents[2] / "cpp" / "kernelmap"
          / "kernel_map.cpp")
BUILDERS = ("native", "numpy")
BUILDS: "collections.Counter[str]" = collections.Counter()
REGIONS = ("hypercube", "hypercross")

_LIB = None
_LIB_LOCK = threading.Lock()


def _native_lib():
    """The compiled builder, built on first use (``utils/native.py``)."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is not None:
            return _LIB
        from numpy.ctypeslib import ndpointer

        so = build_library(SOURCE, "libgmfkmap",
                           "the native kernel-map builder")
        lib = ctypes.cdll.LoadLibrary(str(so))
        lib.build_kernel_map.restype = ctypes.c_int
        lib.build_kernel_map.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ndpointer(ctypes.c_int32, flags="C_CONTIGUOUS"),
            ndpointer(ctypes.c_int32, flags="C_CONTIGUOUS"),
            ndpointer(ctypes.c_int32, flags="C_CONTIGUOUS"),
            ndpointer(ctypes.c_int32, flags="C_CONTIGUOUS"),
        ]
        _LIB = lib
        return lib


def hypercube_offsets(kernel_size: int, dim: int,
                      stride_units: int = 1) -> np.ndarray:
    """All offsets of a centered hypercube kernel: [(k^D), D] int32.

    Offsets are multiples of ``stride_units`` (the tensor stride t).
    Matches ME.RegionType.HYPER_CUBE with odd kernel sizes.
    """
    r = kernel_size // 2
    axes = [np.arange(-r, r + 1) * stride_units] * dim
    grid = np.meshgrid(*axes, indexing="ij")
    return np.stack([g.ravel() for g in grid], axis=-1).astype(np.int32)


def hypercross_offsets(kernel_size: int, dim: int,
                       stride_units: int = 1) -> np.ndarray:
    """Cross (axis-aligned) offsets: [1 + 2 r D, D] int32, the centre
    first, then for each axis the offsets -1, +1, ..., -r, +r times
    ``stride_units`` (r = kernel_size // 2). Matches
    ME.RegionType.HYPER_CROSS (the model registry's *X variants)."""
    r = kernel_size // 2
    rows = [np.zeros((1, dim), np.int64)]
    for d in range(dim):
        for s in range(1, r + 1):
            for sign in (-1, 1):
                v = np.zeros((1, dim), np.int64)
                v[0, d] = sign * s * stride_units
                rows.append(v)
    return np.concatenate(rows, axis=0).astype(np.int32)


def region_offsets(region: str):
    """``hypercube_offsets`` or ``hypercross_offsets`` by name; any other
    name raises."""
    if region == "hypercube":
        return hypercube_offsets
    if region == "hypercross":
        return hypercross_offsets
    raise ValueError(f"unknown kernel region {region!r}; expected one of "
                     f"{REGIONS}")


def _lookup(keys_sorted: np.ndarray, order: np.ndarray,
            query_keys: np.ndarray, sentinel: int) -> np.ndarray:
    """Vectorized hash-free lookup: original index of each query key, or
    sentinel when absent."""
    pos = np.searchsorted(keys_sorted, query_keys)
    # searchsorted never returns < 0; only the upper bound needs clamping
    np.minimum(pos, len(keys_sorted) - 1, out=pos)
    hit = keys_sorted[pos] == query_keys
    idx = np.where(hit, order[pos], sentinel)
    return idx.astype(np.int32)


def _prune(nbr, kept, sentinel):
    """Drop offsets without a match, always keeping offset K // 2 (the
    hypercube's centre; gmf_tpu keeps the same index of a hypercross)."""
    K = len(kept)
    nonempty = (nbr != sentinel).any(axis=1)
    nonempty |= np.arange(K) == K // 2
    return nbr[nonempty], kept[nonempty]


def build_kernel_map(in_coords: np.ndarray, out_coords: np.ndarray,
                     offsets: np.ndarray, prune_empty: bool = False,
                     in_valid: Optional[int] = None,
                     builder: str = "native"):
    """Dense per-offset neighbour table.

    Args:
      in_coords:  [N, D] int input voxel coords (valid rows only).
      out_coords: [M, D] int output voxel coords.
      offsets:    [K, D] int kernel offsets (in input-lattice units).
      prune_empty: drop offsets with zero matches (6-D essential).
      in_valid: the sentinel, where it is not N (an input capacity past
        the valid rows).
      builder: "native" (the C++ hash builder) or "numpy" (module
        docstring); any other name raises.

    Returns:
      (nbr [K', M] int32 with sentinel N (or ``in_valid``), kept_offsets
      [K'] int32 indices into the original offset list).
    """
    if builder not in BUILDERS:
        raise ValueError(f"unknown kernel-map builder {builder!r}; "
                         f"expected one of {BUILDERS}")
    N = len(in_coords)
    sentinel = N if in_valid is None else int(in_valid)
    K = len(offsets)
    kept = np.arange(K, dtype=np.int32)
    if len(in_coords) == 0 or len(out_coords) == 0:
        return np.full((K, len(out_coords)), sentinel, np.int32), kept
    BUILDS[builder] += 1
    if builder == "native":
        nbr = _native_kernel_map(in_coords, out_coords, offsets)
        if sentinel != N:  # the native builder's sentinel is N
            nbr[nbr == N] = sentinel
    else:
        nbr = _numpy_kernel_map(in_coords, out_coords, offsets, sentinel)
    if prune_empty:
        return _prune(nbr, kept, sentinel)
    return nbr, kept


def _native_kernel_map(in_coords, out_coords, offsets):
    """The native builder: [K, M] int32 table, the offsets split over
    host threads (each call hashes the inputs and fills its rows)."""
    from concurrent.futures import ThreadPoolExecutor

    lib = _native_lib()
    K, M, D = len(offsets), len(out_coords), in_coords.shape[1]
    in_c = np.ascontiguousarray(in_coords, np.int32)
    out_c = np.ascontiguousarray(out_coords, np.int32)
    offs = np.ascontiguousarray(offsets, np.int32)
    nbr = np.empty((K, M), np.int32)
    parts = [p for p in np.array_split(
        np.arange(K), min(K, len(os.sched_getaffinity(0)))) if len(p)]

    def fill(part):
        k0, k1 = int(part[0]), int(part[-1]) + 1
        return lib.build_kernel_map(len(in_c), M, D, k1 - k0, in_c, out_c,
                                    offs[k0:k1], nbr[k0:k1])

    with ThreadPoolExecutor(len(parts)) as ex:
        rcs = list(ex.map(fill, parts))
    if any(rcs):
        raise ValueError(
            "the native kernel-map builder cannot pack these coordinates "
            "into int64 keys (their extent is too large); pass "
            "builder='numpy' to build this map with NumPy")
    return nbr


def _numpy_kernel_map(in_coords, out_coords, offsets, sentinel):
    """The NumPy builder: [K, M] int32 table, sentinel where absent."""
    # Pack input and all query coords in one shared frame so keys align.
    all_min = np.minimum(in_coords.min(0), out_coords.min(0) + offsets.min(0))
    cin = in_coords.astype(np.int64) - all_min
    qbase = out_coords.astype(np.int64) - all_min
    span = np.maximum(
        cin.max(0), qbase.max(0) + np.maximum(offsets.max(0), 0)
    ) + 1
    if np.sum(np.log2(span.astype(np.float64) + 1.0)) > 62:
        raise ValueError(f"extent too large for int64 packing: {span}")
    strides = np.ones(cin.shape[1], np.int64)
    for d in range(cin.shape[1] - 2, -1, -1):
        strides[d] = strides[d + 1] * span[d + 1]

    keys = cin @ strides
    order = np.argsort(keys, kind="stable").astype(np.int64)
    keys_sorted = keys[order]

    K = len(offsets)
    M = len(out_coords)
    D = in_coords.shape[1]
    # One batched lookup over all K*M queries (the per-offset loop was the
    # host bottleneck at 6-D: 729 x searchsorted). Keys are composed from
    # [M] base keys + [K] offset keys; the per-dim range check uses scalar
    # interval comparisons against [M] columns (no [K, M, D] int64 blowup).
    off64 = offsets.astype(np.int64)
    qkeys = (qbase @ strides)[None, :] + (off64 @ strides)[:, None]  # [K, M]
    in_range = np.ones((K, M), bool)
    for d in range(D):
        col = qbase[:, d]  # [M]
        lo = -off64[:, d:d + 1]              # [K, 1]
        hi = span[d] - off64[:, d:d + 1]
        in_range &= (col[None, :] >= lo) & (col[None, :] < hi)
    idx = _lookup(keys_sorted, order, qkeys.ravel(), sentinel)
    nbr = np.where(in_range, idx.reshape(K, M), sentinel).astype(np.int32)
    return nbr


def downsample_coords(coords: np.ndarray, stride: int,
                      tensor_stride: int = 1) -> np.ndarray:
    """Output coords of a stride-s conv: unique floor-quantized coords.

    Matches ME's coordinate-map downsampling (floor to the s*t lattice).
    """
    st = stride * tensor_stride
    q = np.floor_divide(coords.astype(np.int64), st) * st
    return np.unique(q, axis=0).astype(np.int32)


# ---------------------------------------------------------------------------
# Multi-level pyramid for ResUNet-style encoders/decoders
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LevelMaps:
    """Static-shape kernel maps for one resolution level."""

    coords: np.ndarray          # [cap, D] padded voxel coords
    num_valid: int              # valid voxels at this level
    cap: int                    # padded capacity (static)
    self_map: np.ndarray        # [K', cap] stride-1 k3 map (blocks)
    self_kept: np.ndarray       # kept offset ids for self_map
    down_map: Optional[np.ndarray] = None   # [K', cap_next] maps l -> l+1
    down_kept: Optional[np.ndarray] = None
    up_map: Optional[np.ndarray] = None     # [K', cap] maps l+1 -> l
    up_kept: Optional[np.ndarray] = None


@dataclasses.dataclass
class SparsePyramid:
    """All kernel maps for a ResUNet2 forward pass (host-built, static)."""

    levels: List[LevelMaps]
    dim: int
    conv1_map: np.ndarray       # level-0 map for the first conv (k may differ)
    conv1_kept: np.ndarray
    conv1_volume: int = 0       # offsets of conv1's kernel before pruning

    @property
    def num_levels(self):
        return len(self.levels)


def pyramid_map_stats(pyr: SparsePyramid):
    """{"voxels": [n a level], "maps": {name: {k, m, occupancy}}}: K' and
    M of each map of the pyramid ("conv1", "self_l", "down_l", "up_l")
    and its share of entries that are not the sentinel (the input
    level's capacity)."""
    caps = [lv.cap for lv in pyr.levels]
    maps = {"conv1": (pyr.conv1_map, caps[0])}
    for l, lv in enumerate(pyr.levels):
        maps[f"self_{l}"] = (lv.self_map, caps[l])
        if lv.down_map is not None:
            maps[f"down_{l}"] = (lv.down_map, caps[l])
            maps[f"up_{l}"] = (lv.up_map, caps[l + 1])
    return dict(voxels=[lv.num_valid for lv in pyr.levels],
                maps={name: dict(k=int(m.shape[0]), m=int(m.shape[1]),
                                 occupancy=float((m != sentinel).mean()))
                      for name, (m, sentinel) in maps.items()})


def _pad_cap(n: int, granule: int = 512) -> int:
    """Round a capacity up to a bucket (gmf_tpu compiles once a bucket;
    the port keeps its shapes)."""
    return max(granule, -(-n // granule) * granule)


def _remap_with_padding(nbr: np.ndarray, n_valid_in: int, cap_in: int):
    """Point sentinel at the padded-input zero row (index cap_in)."""
    out = nbr.copy()
    out[out == n_valid_in] = cap_in
    return out


def _pad_offsets(nbr: np.ndarray, kept: np.ndarray, sentinel: int,
                 granule: int = 32, max_k: Optional[int] = None):
    """Round the active-offset count up to a bucket of 32, the
    convolution's chunk. Padded offsets get all-sentinel rows (zero
    contribution) and kept-id 0 (weight value irrelevant)."""
    K = nbr.shape[0]
    target = min(-(-K // granule) * granule, max_k) if max_k else (
        -(-K // granule) * granule)
    if target <= K:
        return nbr, kept
    pad_rows = np.full((target - K, nbr.shape[1]), sentinel, nbr.dtype)
    pad_ids = np.zeros((target - K,), kept.dtype)
    return (np.concatenate([nbr, pad_rows], axis=0),
            np.concatenate([kept, pad_ids], axis=0))


def build_pyramid(coords: np.ndarray, num_levels: int,
                  conv1_kernel_size: int = 3, dim: Optional[int] = None,
                  granule: int = 512,
                  caps: Optional[Sequence[int]] = None,
                  builder: str = "native",
                  region: str = "hypercube") -> SparsePyramid:
    """Build padded coords + kernel maps for every ResUNet level.

    Level l has tensor stride 2^l. ``caps`` optionally pins per-level
    capacities (otherwise rounded up to ``granule``). ``builder`` names
    the kernel-map builder (``build_kernel_map``). ``region``: the
    kernels' offsets, "hypercube" or "hypercross" (the *X variants);
    pruning keeps offset K // 2 of either, as gmf_tpu does.
    """
    dim = dim if dim is not None else coords.shape[1]
    offs = region_offsets(region)

    level_coords = [coords.astype(np.int32)]
    for l in range(1, num_levels):
        level_coords.append(
            downsample_coords(level_coords[l - 1], 2, 2 ** (l - 1))
        )

    prune = dim > 3  # offset pruning pays off in high-D only
    levels: List[LevelMaps] = []
    for l, c in enumerate(level_coords):
        n = len(c)
        cap = caps[l] if caps is not None else _pad_cap(n, granule)
        c_pad = np.zeros((cap, dim), np.int32)
        c_pad[:n] = c
        # Fill padding with far-away coords so they never collide.
        if cap > n:
            c_pad[n:] = np.int32(2 ** 20)
        t = 2 ** l
        k3 = offs(3, dim, t)
        self_map, self_kept = build_kernel_map(
            c, c, k3, prune_empty=prune, builder=builder)
        if prune:
            self_map, self_kept = _pad_offsets(self_map, self_kept, n,
                                               max_k=len(k3))
        self_map = _remap_with_padding(self_map, n, cap)
        # pad M dimension to cap with sentinel
        self_map = np.pad(self_map, ((0, 0), (0, cap - self_map.shape[1])),
                          constant_values=cap)
        levels.append(LevelMaps(
            coords=c_pad, num_valid=n, cap=cap,
            self_map=self_map, self_kept=self_kept,
        ))

    for l in range(num_levels - 1):
        fine, coarse = levels[l], levels[l + 1]
        t = 2 ** l
        k3 = offs(3, dim, t)
        cf = level_coords[l]
        cc = level_coords[l + 1]
        down, down_kept = build_kernel_map(
            cf, cc, k3, prune_empty=prune, builder=builder)
        if prune:
            down, down_kept = _pad_offsets(down, down_kept, fine.num_valid,
                                           max_k=len(k3))
        down = _remap_with_padding(down, fine.num_valid, fine.cap)
        down = np.pad(down, ((0, 0), (0, coarse.cap - down.shape[1])),
                      constant_values=fine.cap)
        fine.down_map, fine.down_kept = down, down_kept
        # transpose: fine outputs j gather coarse inputs at c_j + o for the
        # REVERSED offsets (pair (i_fine=c_j, j_coarse=c_j+o) exists in the
        # forward map with offset -o; ME indexes transpose kernels by the
        # forward offset, so we negate to stay weight-compatible).
        up, up_kept = build_kernel_map(
            cc, cf, -k3, prune_empty=prune, builder=builder)
        if prune:
            up, up_kept = _pad_offsets(up, up_kept, coarse.num_valid,
                                       max_k=len(k3))
        up = _remap_with_padding(up, coarse.num_valid, coarse.cap)
        up = np.pad(up, ((0, 0), (0, fine.cap - up.shape[1])),
                    constant_values=coarse.cap)
        fine.up_map, fine.up_kept = up, up_kept

    k1 = offs(conv1_kernel_size, dim, 1)
    conv1_map, conv1_kept = build_kernel_map(
        level_coords[0], level_coords[0], k1, prune_empty=prune,
        builder=builder)
    if prune:
        conv1_map, conv1_kept = _pad_offsets(
            conv1_map, conv1_kept, levels[0].num_valid, max_k=len(k1))
    conv1_map = _remap_with_padding(conv1_map, levels[0].num_valid,
                                    levels[0].cap)
    conv1_map = np.pad(
        conv1_map, ((0, 0), (0, levels[0].cap - conv1_map.shape[1])),
        constant_values=levels[0].cap)

    return SparsePyramid(levels=levels, dim=dim, conv1_map=conv1_map,
                         conv1_kept=conv1_kept, conv1_volume=len(k1))
