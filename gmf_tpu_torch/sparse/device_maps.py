"""Kernel maps built on the device: packed int64 keys, sorted once a level,
one exact binary-search probe.

Counterpart of ``gmf_tpu/sparse/device_maps.py``. The host builders
(``kernel_map.py``) probe K x M coordinate keys on the CPU, ~20 million
for a 20,000-voxel 6-D map; here the same lookup runs on the device and
the tables are born where the convolutions read them.

``gmf_tpu`` reaches its maps through TPU gather-rate tiers (a
direct-address table with lane groups, a 3-table hash, chained split
probes, the src-dense probe and its row mode), each tuned on a v5e and
each giving the maps of its exact sorted path (``device_maps.py:203-209``
there). The port keeps that one path:

- coordinates divide by the level's lattice stride (level coordinates
  are multiples of it, so floor division is exact) and pack into int64
  keys over a frame that covers the input level's valid rows and every
  query made against it;
- an input level's keys are sorted once and serve its self map, its
  down map and, at level 0, conv1's map;
- query keys are composed from [M] base keys and [K] offset keys (never
  [K, M, D]), answered by ``torch.searchsorted`` and masked by a
  per-dimension range check, which keeps packing aliases out;
- offsets go in chunks, so that the live [Kc, M] int64 keys stay within
  ``QUERY_BYTES``.

The frame is checked on the host, from the coordinates the builder holds:
keys that would not fit 62 bits raise a ``ValueError`` naming the spans.
Every table equals the host builder's and ``gmf_tpu``'s in every bit
(tests/test_torch_device_maps.py).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from gmf_tpu_torch.sparse.compact import (build_compact_schedules,
                                          invert_map, schedule_row_stats)
from gmf_tpu_torch.sparse.kernel_map import (_pad_cap, downsample_coords,
                                             region_offsets)
from gmf_tpu_torch.utils.device import resolve_device

QUERY_BYTES = 1 << 29      # live [Kc, M] int64 query keys of one chunk
_KEY_LIMIT = 1 << 62       # every packed key lies below this
_INVALID_KEY = 1 << 62     # an input row that matches no query


def _frame(in_coords: np.ndarray, queries, lattice: int):
    """Packing frame of one input level, in lattice units: (lo [D] int64,
    spans [D] ints, strides [D] int64), or None when the level has no
    rows.

    ``in_coords``: the level's valid rows; ``queries``: (out_coords valid
    rows, offsets) of every map probed against it. ``lo`` covers the
    input rows and every query's low corner, ``spans`` the input rows
    (a query outside them is masked by the range check), as gmf_tpu's
    frame (``device_maps.py:170-182``)."""
    if len(in_coords) == 0:
        return None
    c = in_coords.astype(np.int64) // lattice
    lo, hi = c.min(0), c.max(0)
    top, reach = hi.copy(), np.zeros_like(hi)
    for out, offs in queries:
        if len(out) == 0:
            continue
        o = out.astype(np.int64) // lattice
        k = offs.astype(np.int64) // lattice
        lo = np.minimum(lo, o.min(0) + k.min(0))
        top = np.maximum(top, o.max(0))
        reach = np.maximum(reach, np.abs(k).max(0))
    spans = [int(h - l + 1) for h, l in zip(hi, lo)]
    strides = [1] * len(spans)
    for d in range(len(spans) - 2, -1, -1):
        strides[d] = strides[d + 1] * spans[d + 1]
    # every key, input or query, lies in [0, bound]
    bound = sum((int(t) - int(l) + int(r)) * s
                for t, l, r, s in zip(top, lo, reach, strides))
    if max(bound, strides[0] * spans[0]) >= _KEY_LIMIT:
        raise ValueError(
            f"coordinates too far apart to pack into int64 keys: spans "
            f"{spans} (lattice {lattice}) give keys up to "
            f"{max(bound, strides[0] * spans[0])}, past 2^62")
    return lo, spans, np.array(strides, np.int64)


class _SortedLevel:
    """One input level's packed keys, sorted on the device."""

    def __init__(self, coords, valid, frame, lattice: int):
        """coords: [cap, D] int32 on the device (padded rows allowed);
        valid: [cap] bool; frame: ``_frame``'s result (not None)."""
        lo, spans, strides = frame
        dev = coords.device
        self.lattice = lattice
        self.lo = torch.as_tensor(lo, device=dev)
        self.spans = spans
        self.strides_np = strides
        self.strides = torch.as_tensor(strides, device=dev)
        rel = self._lattice(coords) - self.lo
        keys = torch.where(valid, (rel * self.strides).sum(1),
                           torch.full_like(rel[:, 0], _INVALID_KEY))
        self.keys, order = torch.sort(keys)
        self.order = order.to(torch.int32)

    def _lattice(self, coords):
        return torch.div(coords.long(), self.lattice, rounding_mode="floor")

    def probe(self, out_coords, out_valid, offsets: np.ndarray,
              sentinel: int):
        """[K, M] int32: the input row at out + offset, or ``sentinel``.

        out_coords [M, D] int32 and out_valid [M] bool on the device;
        offsets [K, D] host ints, multiples of the lattice stride."""
        dev = out_coords.device
        K, M, N = len(offsets), out_coords.shape[0], self.keys.shape[0]
        offs = offsets.astype(np.int64) // self.lattice
        rel = self._lattice(out_coords) - self.lo               # [M, D]
        out_key = (rel * self.strides).sum(1)                   # [M]
        off_key = torch.as_tensor(offs @ self.strides_np, device=dev)
        offs_t = torch.as_tensor(offs, device=dev)
        nbr = torch.empty((K, M), dtype=torch.int32, device=dev)
        kc = max(1, QUERY_BYTES // (8 * max(M, 1)))
        for k0 in range(0, K, kc):
            q = out_key[None, :] + off_key[k0:k0 + kc, None]    # [Kc, M]
            in_range = out_valid[None, :]
            for d, span in enumerate(self.spans):
                col, od = rel[None, :, d], offs_t[k0:k0 + kc, d:d + 1]
                in_range = in_range & (col >= -od) & (col < span - od)
            pos = torch.searchsorted(self.keys, q).clamp_(max=N - 1)
            hit = (self.keys[pos] == q) & in_range
            nbr[k0:k0 + kc] = torch.where(hit, self.order[pos], sentinel)
        return nbr


def device_kernel_map(in_coords, out_coords, offsets, in_valid_mask,
                      out_valid_mask, sentinel: int, lattice: int = 1):
    """Dense per-offset neighbour table on the coordinates' device.

    Args:
      in_coords: [N, D] int tensor (padded rows allowed; mask them).
      out_coords: [M, D] int tensor on the same device.
      offsets: [K, D] ints (host), multiples of ``lattice``.
      in_valid_mask / out_valid_mask: [N] / [M], nonzero = valid; an
        invalid output row gets an all-sentinel column.
      sentinel: the value of a missing neighbour.
      lattice: the coordinates' lattice stride (level l: 2^l).

    Returns nbr [K, M] int32, equal to gmf_tpu's ``device_kernel_map``.
    The frame is checked on the host, so this fetches the valid rows;
    ``build_pyramid_arrays_device`` frames from the coordinates it holds.
    """
    offsets = np.asarray(offsets)
    in_valid, out_valid = in_valid_mask != 0, out_valid_mask != 0
    in_host = in_coords[in_valid].cpu().numpy()
    out_host = out_coords[out_valid].cpu().numpy()
    frame = _frame(in_host, [(out_host, offsets)], lattice)
    if frame is None:
        return torch.full((len(offsets), out_coords.shape[0]), sentinel,
                          dtype=torch.int32, device=out_coords.device)
    level = _SortedLevel(in_coords, in_valid, frame, lattice)
    return level.probe(out_coords, out_valid, offsets, sentinel)


def _kept_offsets(counts: np.ndarray, kernel_volume: int, granule: int = 32):
    """The pruned offsets of a map from its per-offset hit counts: the
    non-empty ones and the centre, in order, padded with id 0 to a
    multiple of ``granule`` (at most K). Returns (kept [K'], number of
    real ids) -- the host pruning's rule (``kernel_map._prune`` and
    ``_pad_offsets``)."""
    K = len(counts)
    nonempty = np.asarray(counts) > 0
    nonempty[kernel_volume // 2] = True
    kept = np.nonzero(nonempty)[0].astype(np.int32)
    target = min(-(-len(kept) // granule) * granule, K)
    padded = np.zeros((target,), np.int32)
    padded[:len(kept)] = kept
    return padded, len(kept)


def _prune_and_pad(nbr, counts, cap_in: int, kernel_volume: int):
    """``_kept_offsets``' rows of ``nbr``; padded rows all-sentinel. A map
    that loses no row is returned as it is."""
    K = nbr.shape[0]
    kept, n = _kept_offsets(counts, kernel_volume)
    if n == K and len(kept) == K:
        return nbr, torch.arange(K, dtype=torch.int32, device=nbr.device)
    rows = np.full((len(kept),), K, np.int64)
    rows[:n] = kept[:n]
    ext = torch.cat([nbr, nbr.new_full((1, nbr.shape[1]), cap_in)])
    return (ext.index_select(0, torch.as_tensor(rows, device=nbr.device)),
            torch.as_tensor(kept, device=nbr.device))


def build_pyramid_arrays_device(
        coords: np.ndarray, num_levels: int, conv1_kernel_size: int = 3,
        dim: Optional[int] = None, granule: int = 512,
        caps: Optional[Sequence[int]] = None, compact_conv: bool = False,
        compact_dense_frac: float = 0.5, device=None,
        stats: Optional[Dict] = None,
        region: str = "hypercube") -> Dict[str, object]:
    """The nets' pyramid dict with every kernel map built on ``device``
    (the card unless ``device="cpu"``): the arrays of
    ``pyramid_to_arrays(build_pyramid(...))``, bit for bit.

    The host downsamples each level (a sort-unique of its coordinates)
    and frames it; every probe is dispatched before the first fetch. In
    high D one fetch brings every map's per-offset hit counts, which
    prune each map (gmf_tpu's ``_prune_and_pad_device``) and, with
    ``compact_conv``, size its compacted schedules (``compact.py``:
    ``*_cmp`` keys in place of the dense maps). Each up map is its down
    map inverted (by offset index, so for either region); conv1 reuses
    the level-0 self map when its kernel is 3 (the same offsets at stride
    1 in either region). The dict also carries ``conv1_volume``.
    ``region``: "hypercube" or "hypercross" (``kernel_map.
    build_pyramid``'s); pruning keeps offset K // 2 of either.

    ``stats``: when a dict, it receives {"voxels": [n a level], "maps":
    {name: {k, m, occupancy}}}, K' and M of each (pruned) map and its
    share of entries that are not the sentinel, from the fetched counts
    (compacted maps add ``dense_rows`` and ``compact_rows``,
    ``compact.schedule_row_stats``).
    """
    dev = resolve_device(device)
    dim = dim if dim is not None else coords.shape[1]
    offs_fn = region_offsets(region)
    prune = dim > 3
    level_coords = [coords.astype(np.int32)]
    for l in range(1, num_levels):
        level_coords.append(
            downsample_coords(level_coords[l - 1], 2, 2 ** (l - 1)))
    n_l = [len(c) for c in level_coords]
    cap_l = [caps[l] if caps is not None else _pad_cap(n, granule)
             for l, n in enumerate(n_l)]
    cpad_l, valid_l = [], []
    for c, cap in zip(level_coords, cap_l):
        c_pad = np.zeros((cap, dim), np.int32)
        c_pad[:len(c)] = c
        cpad_l.append(torch.as_tensor(c_pad, device=dev))
        valid_l.append(torch.arange(cap, device=dev) < len(c))

    # (name, input level, output level, kernel size); level l's offsets
    # are multiples of its stride 2^l
    jobs = []
    for l in range(num_levels):
        jobs.append((f"self_{l}", l, l, 3))
        if l + 1 < num_levels:
            jobs.append((f"down_{l}", l, l + 1, 3))
    if conv1_kernel_size != 3:
        jobs.append(("conv1", 0, 0, conv1_kernel_size))
    offs = {name: offs_fn(k, dim, 2 ** l_in)
            for name, l_in, _, k in jobs}
    nbr = {}
    for l in range(num_levels):
        mine = [j for j in jobs if j[1] == l]
        frame = _frame(level_coords[l], [(level_coords[l_out], offs[name])
                                         for name, _, l_out, _ in mine],
                       2 ** l)
        if frame is None:
            for name, _, l_out, _ in mine:
                nbr[name] = torch.full((len(offs[name]), cap_l[l_out]),
                                       cap_l[l], dtype=torch.int32,
                                       device=dev)
            continue
        level = _SortedLevel(cpad_l[l], valid_l[l], frame, 2 ** l)
        for name, _, l_out, _ in mine:
            nbr[name] = level.probe(cpad_l[l_out], valid_l[l_out],
                                    offs[name], cap_l[l])

    counts: Dict[str, np.ndarray] = {}
    if prune or stats is not None:
        hits = torch.cat([(nbr[name] != cap_l[l_in]).sum(1, dtype=torch.int32)
                          for name, l_in, _, _ in jobs]).cpu().numpy()
        at = 0
        for name, _, _, _ in jobs:
            counts[name] = hits[at:at + len(offs[name])]
            at += len(offs[name])

    arrays: Dict[str, object] = {
        f"mask_{l}": valid_l[l].to(torch.float32) for l in range(num_levels)}
    arrays["conv1_volume"] = len(offs_fn(conv1_kernel_size, dim))
    map_stats: Dict[str, Dict] = {}

    def key(name, what):
        return f"conv1_{what}" if name == "conv1" else name.replace(
            "_", f"_{what}_")

    def stat(name, width, **more):
        k = (len(_kept_offsets(counts[name], len(offs[name]))[0]) if prune
             else len(offs[name]))
        return dict(k=k, m=width,
                    occupancy=int(counts[name].sum()) / max(k * width, 1),
                    **more)

    if compact_conv and prune:
        scheds = build_compact_schedules([
            (nbr[name], counts[name], cap_l[l_in], cap_l[l_out],
             name.startswith("down"), compact_dense_frac)
            for name, l_in, l_out, _ in jobs])
        for (name, l_in, l_out, _), sched in zip(jobs, scheds):
            # up schedules: the down schedule's pairs, in and out swapped
            pairs = ((name, sched, cap_l[l_out]),)
            if name.startswith("down"):
                pairs = ((name, sched[0], cap_l[l_out]),
                         (f"up_{l_in}", sched[1], cap_l[l_in]))
            for nm, s, width in pairs:
                arrays[key(nm, "cmp")] = s
                if stats is not None:
                    d, c = schedule_row_stats(s)
                    map_stats[nm] = stat(name, width, dense_rows=d,
                                         compact_rows=c)
        if conv1_kernel_size == 3:
            arrays["conv1_cmp"] = arrays["self_cmp_0"]
    else:
        for name, l_in, l_out, _ in jobs:
            m = nbr[name]
            if prune:
                m, kept = _prune_and_pad(m, counts[name], cap_l[l_in],
                                         len(offs[name]))
            else:
                kept = torch.arange(m.shape[0], dtype=torch.int32, device=dev)
            arrays[key(name, "map")], arrays[key(name, "kept")] = m, kept
            if stats is not None:
                map_stats[name] = stat(name, cap_l[l_out])
            if name.startswith("down"):
                # the transpose map is the forward one inverted: pair (fine
                # i, coarse j) at offset a is pair (j, i) at offset a of the
                # negated list, the host's -k3 build (the same kept set)
                arrays[f"up_map_{l_in}"] = invert_map(m, cap_l[l_in],
                                                      cap_l[l_out])
                arrays[f"up_kept_{l_in}"] = kept
                if stats is not None:
                    map_stats[f"up_{l_in}"] = stat(name, cap_l[l_in])
        if conv1_kernel_size == 3:
            arrays["conv1_map"] = arrays["self_map_0"]
            arrays["conv1_kept"] = arrays["self_kept_0"]
    if stats is not None:
        if conv1_kernel_size == 3:
            map_stats["conv1"] = map_stats["self_0"]
        stats.update(voxels=n_l, maps=map_stats)
    return arrays
