"""Compacted tile schedules for the 6-D sparse convolution.

Counterpart of ``gmf_tpu/sparse/compact.py``. A 6-D kernel map is
0.2-4% occupied, so the dense-map convolution spends nearly all of its
gathers and products on the zero sentinel row. A schedule keeps only the
hits, in two tiers:

  dense tier - offsets with at least ``dense_frac * M`` hits keep their
               [Kd, M] map rows and run the dense-map convolution;
  tile tier  - every other offset's hits, in order of their output
               column, fill fixed tiles of ``TILE`` columns: (in_idx
               [Nt, T], out_idx [Nt, T], kept [Nt]), ``kept`` each tile's
               offset id. A partial tile pads with (cap_in, cap_out): the
               input's zero row in, the output's trash row out.

The plan (which offsets go where, the tiles per offset, the power-of-two
buckets of every count) is ``gmf_tpu``'s, on the host from the per-offset
hit counts the pyramid builder fetched, so the arrays equal ``gmf_tpu``'s
in every bit. ``gmf_tpu`` finds a tile slot's hit by a two-level popcount
rank-select, which is TPU gather tuning; here ``torch.nonzero`` lists the
hits row-major with ascending columns, so hit q of compact row r goes to
slot ``tile_base[r] * TILE + q`` directly. Up (transpose) schedules are
the down schedule's pairs with in and out swapped; its dense tier is
inverted (``invert_map``), its sentinel the up convolution's
input capacity.

``conv.py::sparse_conv_compact`` runs a schedule: the dense tier through
``sparse_conv``, the tiles as gather, batched product and ``index_add_``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

TILE = 128          # fixed tile width
SEG_GRANULE = 8     # compact-row and tile counts bucket from this


def _pow2_bucket(x: int, lo: int = SEG_GRANULE) -> int:
    b = lo
    while b < x:
        b <<= 1
    return b


def plan_tiles(counts: np.ndarray, m: int, tile: int = TILE,
               dense_frac: float = 0.5
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Split the active offsets into a dense tier and fixed-width tiles.

    Args:
      counts: [K] per-offset hit counts (host ints).
      m: the map's output width (cap_out).
      dense_frac: offsets with count >= dense_frac * m stay dense.

    Returns (dense_ids [Kd], compact_ids [Kc], tiles_per_id [Kc]); ids
    index the original offset axis, in order of falling count.
    """
    counts = np.asarray(counts)
    ids = np.nonzero(counts > 0)[0]
    order = np.argsort(-counts[ids], kind="stable")
    ids = ids[order].astype(np.int32)
    c = counts[ids]
    dense = c >= dense_frac * m
    return (ids[dense], ids[~dense],
            (-(-c[~dense] // tile)).astype(np.int32))


def _plan(counts, cap_out: int, tile: int, dense_frac: float):
    """(ids, kd, kc, base, kd_pad, kc_pad, nt_pad): the offset ids, dense
    tier first, each tier zero-padded to its bucket; the real tier sizes;
    each compact offset's first tile (padded rows at tile nt_pad); the
    buckets (gmf_tpu's ``_plan``)."""
    dense_ids, compact_ids, tiles_per = plan_tiles(counts, int(cap_out),
                                                   tile=tile,
                                                   dense_frac=dense_frac)
    kd, kc, nt = len(dense_ids), len(compact_ids), int(tiles_per.sum())
    # a dense row is a whole map row: bucket its count from 1, not 8
    kd_pad = _pow2_bucket(kd, lo=1) if kd else 0
    kc_pad = _pow2_bucket(kc) if kc else 0
    nt_pad = _pow2_bucket(nt) if nt else 0
    ids = np.zeros(kd_pad + kc_pad, np.int32)
    ids[:kd] = dense_ids
    ids[kd_pad:kd_pad + kc] = compact_ids
    base = np.full(kc_pad, nt_pad, np.int32)
    base[:kc] = np.cumsum(tiles_per) - tiles_per
    return ids, kd, kc, base, kd_pad, kc_pad, nt_pad


def invert_map(rows, width: int, fill: int):
    """Transpose of a map: [R, M] (entries in [0, width], ``width`` the
    sentinel) -> [R, width] with out[r, rows[r, j]] = j, ``fill``
    elsewhere. Sentinel entries land in a trash column that is dropped,
    so the only colliding writes are discarded ones."""
    R, M = rows.shape
    ext = rows.new_full((R, width + 1), fill)
    cols = torch.arange(M, dtype=rows.dtype, device=rows.device)
    ext.scatter_(1, rows.long(), cols.expand(R, M))
    return ext[:, :width].contiguous()


def _compact_map(nbr, counts, cap_in: int, cap_out: int, with_up: bool,
                 dense_frac: float, tile: int):
    """One map's schedule, and its up schedule when ``with_up``."""
    dev = nbr.device
    ids, kd, kc, base, kd_pad, kc_pad, nt_pad = _plan(counts, cap_out, tile,
                                                      dense_frac)
    sched: Dict = {"dense": None, "groups": ()}
    up: Dict = {"dense": None, "groups": ()}
    if kd_pad:
        kept = torch.as_tensor(ids[:kd_pad], device=dev)
        rows = nbr.index_select(0, kept.long())
        rows[kd:] = cap_in
        sched["dense"] = (rows, kept)
        if with_up:
            up["dense"] = (invert_map(rows, cap_in, cap_out), kept)
    if kc_pad and nt_pad:
        cids = ids[kd_pad:kd_pad + kc_pad]
        rows = nbr.index_select(0, torch.as_tensor(cids[:kc], device=dev
                                                   ).long())
        r, c = torch.nonzero(rows != cap_in, as_tuple=True)
        # the hits of row r are consecutive and in column order: hit q of
        # row r sits at i = start[r] + q and goes to slot base[r] * tile + q
        per_row = np.asarray(counts)[cids[:kc]].astype(np.int64)
        shift = base[:kc].astype(np.int64) * tile - (np.cumsum(per_row)
                                                      - per_row)
        slot = (torch.arange(r.shape[0], device=dev)
                + torch.as_tensor(shift, device=dev)[r])
        in_idx = torch.full((nt_pad * tile,), cap_in, dtype=torch.int32,
                            device=dev)
        out_idx = torch.full_like(in_idx, cap_out)
        in_idx[slot] = rows[r, c]
        out_idx[slot] = c.to(torch.int32)
        # each tile's compact row; the bucket's padding tiles fall to the
        # last real row, whose slots past its hits are empty
        t_row = np.clip(np.searchsorted(base, np.arange(nt_pad),
                                        side="right") - 1, 0, kc_pad - 1)
        group = (in_idx.view(nt_pad, tile), out_idx.view(nt_pad, tile),
                 torch.as_tensor(cids[t_row], device=dev))
        sched["groups"] = (group,)
        up["groups"] = ((group[1], group[0], group[2]),)
    return (sched, up) if with_up else sched


def build_compact_schedule(nbr, counts: np.ndarray, cap_in: int,
                           cap_out: int, tile: int = TILE,
                           with_transpose: bool = False,
                           dense_frac: float = 0.5):
    """The two-tier schedule of one map.

    Args:
      nbr: [K, M] map on the device, sentinel cap_in.
      counts: [K] host per-offset hit counts.
      cap_in / cap_out: the input and output capacities (sentinels).
      with_transpose: also return the up schedule (the same pairs, in
        and out swapped).

    Returns sched = {"dense": (rows [Kd, M], kept [Kd]) or None,
    "groups": ((in_idx [Nt, T], out_idx [Nt, T], kept [Nt]),) or ()},
    every array on nbr's device, kept ids indexing the whole offset
    axis; or (sched, up_sched) with ``with_transpose``, the up
    schedule's dense rows [Kd, cap_in] with sentinel cap_out.
    """
    return _compact_map(nbr, counts, int(cap_in), int(cap_out),
                        bool(with_transpose), dense_frac, tile)


def build_compact_schedules(jobs, tile: int = TILE):
    """``build_compact_schedule`` of several maps: ``jobs`` holds (nbr,
    counts, cap_in, cap_out, with_transpose, dense_frac) a map; returns a
    list matching it."""
    return [build_compact_schedule(nbr, counts, cap_in, cap_out, tile,
                                   with_transpose, dense_frac)
            for nbr, counts, cap_in, cap_out, with_transpose, dense_frac
            in jobs]


def transpose_schedule(sched: Dict, cap_in: int, cap_out: int) -> Dict:
    """The up schedule of a down schedule: the same pairs, in and out
    swapped. cap_in / cap_out are the UP convolution's (coarse in, fine
    out); a dense tier becomes [Kd, cap_out] rows by inversion, sentinel
    cap_in. ``build_compact_schedules`` with with_transpose gives the
    same arrays."""
    out: Dict = {"dense": None, "groups": ()}
    if sched["dense"] is not None:
        rows, kept = sched["dense"]
        out["dense"] = (invert_map(rows, cap_out, cap_in), kept)
    out["groups"] = tuple((o, i, k) for i, o, k in sched["groups"])
    return out


def schedule_row_stats(sched: Dict) -> Tuple[int, int]:
    """(dense-tier entries, tile slots) of a schedule."""
    d = 0
    if sched["dense"] is not None:
        d = int(np.prod(sched["dense"][0].shape))
    c = sum(int(np.prod(g[0].shape)) for g in sched["groups"])
    return d, c
