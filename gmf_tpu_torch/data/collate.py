"""Bucket padding (host-side NumPy).

Counterpart of ``gmf_tpu/data/collate.py::next_bucket`` and
``pad_to_bucket``: a sample is padded up to the next bucket size with
zeros and gets a ``corr_mask``, so a batch of pairs of different sizes
runs as one [B, bucket, ...] forward.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

BUCKETS = (256, 1000, 2500, 5000, 12000)

_PER_CORR_KEYS = ("corr_pos", "src_keypts", "tgt_keypts", "labels")


def next_bucket(n: int, buckets: Sequence[int] = BUCKETS) -> int:
    """Smallest bucket >= n (largest bucket if n exceeds all)."""
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def pad_to_bucket(sample: Dict[str, np.ndarray],
                  buckets: Sequence[int] = BUCKETS) -> Dict[str, np.ndarray]:
    """Zero-pad the per-correspondence arrays to the next bucket and add
    ``corr_mask``. A sample above the largest bucket is randomly
    subsampled down to it."""
    n = sample["corr_pos"].shape[0]
    b = next_bucket(n, buckets)
    out = dict(sample)
    if n > b:
        sel = np.random.choice(n, b, replace=False)
        for k in _PER_CORR_KEYS:
            if k in out:
                out[k] = out[k][sel]
        n = b
    mask = np.zeros((b,), np.float32)
    mask[:n] = 1.0
    for k in _PER_CORR_KEYS:
        if k in out:
            pad_width = [(0, b - n)] + [(0, 0)] * (out[k].ndim - 1)
            out[k] = np.pad(out[k], pad_width)
    out["corr_mask"] = mask
    return out
