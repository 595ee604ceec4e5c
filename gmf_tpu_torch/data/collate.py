"""Batch collation (host-side NumPy).

Counterpart of ``gmf_tpu/data/collate.py``:

- ``min_clip_collate`` (training, the reference's collate): every sample
  is randomly subsampled down to the batch's smallest correspondence
  count and the samples are stacked;
- ``next_bucket`` and ``pad_to_bucket`` (serving): a sample is padded up
  to the next bucket size with zeros and gets a ``corr_mask``, so a batch
  of pairs of different sizes runs as one [B, bucket, ...] forward.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

BUCKETS = (256, 1000, 2500, 5000, 12000)

_PER_CORR_KEYS = ("corr_pos", "src_keypts", "tgt_keypts", "labels")


def min_clip_collate(samples: Sequence[Dict[str, np.ndarray]],
                     rng: np.random.RandomState | None = None
                     ) -> Dict[str, np.ndarray]:
    """Clip every sample to the batch-min correspondence count and stack.

    Each sample holds unbatched arrays (corr_pos [N, 6], ... images
    [H, W, 3]); the draws are gmf_tpu's, so one ``rng`` state gives the
    same batch in both packages.
    """
    rng = rng or np.random
    n_min = min(s["corr_pos"].shape[0] for s in samples)
    out: Dict[str, List[np.ndarray]] = {k: [] for k in samples[0]}
    for s in samples:
        n = s["corr_pos"].shape[0]
        sel = (rng.choice(n, n_min, replace=False) if n > n_min
               else np.arange(n))
        for k, v in s.items():
            out[k].append(v[sel] if k in _PER_CORR_KEYS else v)
    return {k: np.stack(v) for k, v in out.items()}


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
