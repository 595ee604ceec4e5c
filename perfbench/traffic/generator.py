"""The one traffic generator: synthetic correspondence pairs and arrival
times, from a mix's parameters (``traffic/mixes/<name>.json``) and a seed.

Written for the benchmark (the program's own generator is not imported,
so that a change to the program cannot move the yardstick). A pair is a
known rigid motion of a cloud of keypoints: ``valid`` correspondences, a
share ``inlier_ratio`` of them moved by the motion plus Gaussian noise,
the rest pointing at uniform random places in the target's box; two RGB
images of uniform noise. Keys: corr_pos [n, 6] (each side centred on its
mean), src_keypts, tgt_keypts [n, 3], labels [n], gt_trans [4, 4],
p_image, q_image [H, W, 3], all float32.

Every seed gets the same multiset of sizes, inlier ratios and arrival
gaps (evenly spaced over the mix's ranges and quantiles) in its own
order, so that the work of a window does not change with the seed; the
points, motions, images and bursts are the seed's own.

Mix parameters:

- ``pairs_per_request``, ``pool_requests``: requests are cut from a pool
  of ``pool_requests`` x ``pairs_per_request`` pairs, used in turn.
- ``bucket``: the padded row count the pairs are served at.
- ``valid``: [lo, hi] correspondences a pair; ``inlier_ratio``: [lo, hi].
- ``extent``: [x, y, z] metres of the source box (centred on 0 when
  ``centred``), ``noise``: std of the inliers' noise in metres.
- ``rotation``: "uniform" (any rotation) or {"max_deg": a} (a random
  axis, an angle uniform in [0, a]); ``translation``: {"box": t} (each
  coordinate uniform in [0, t)) or {"max_m": t} (a random direction, a
  length uniform in [0, t]).
- ``image_hw``: [H, W].
- ``arrivals`` (open loop only): {"process": "poisson", "rate": r} per
  second.
"""

from __future__ import annotations

import numpy as np


def spaced(lo, hi, count, rng):
    """``count`` values evenly spaced over [lo, hi], in the seed's order."""
    v = lo + (hi - lo) * (np.arange(count) + 0.5) / count
    return v[rng.permutation(count)]


def random_rotation(rng, spec):
    if spec == "uniform":
        q = rng.standard_normal(4)
        q /= np.linalg.norm(q)
        w, x, y, z = q
        return np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ])
    axis = rng.standard_normal(3)
    axis /= np.linalg.norm(axis)
    a = np.deg2rad(spec["max_deg"]) * rng.random()
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(a) * K + (1 - np.cos(a)) * K @ K


def random_translation(rng, spec):
    if "box" in spec:
        return rng.random(3) * spec["box"]
    d = rng.standard_normal(3)
    return d / np.linalg.norm(d) * spec["max_m"] * rng.random()


def make_pair(rng, mix, valid, inlier_ratio):
    n = int(valid)
    extent = np.asarray(mix["extent"], np.float64)
    low = -extent / 2 if mix.get("centred", False) else np.zeros(3)
    src = low + rng.random((n, 3)) * extent
    R = random_rotation(rng, mix["rotation"])
    t = random_translation(rng, mix["translation"])
    tgt = src @ R.T + t + mix["noise"] * rng.standard_normal((n, 3))
    labels = np.ones(n)
    n_out = int(round(n * (1.0 - inlier_ratio)))
    out = rng.choice(n, n_out, replace=False)
    box_lo = low @ R.T + t
    tgt[out] = box_lo.min(0) + rng.random((n_out, 3)) * extent
    labels[out] = 0.0
    T = np.eye(4)
    T[:3, :3], T[:3, 3] = R, t
    H, W = mix["image_hw"]
    f32 = np.float32
    return {
        "corr_pos": np.concatenate([src - src.mean(0), tgt - tgt.mean(0)],
                                   -1).astype(f32),
        "src_keypts": src.astype(f32),
        "tgt_keypts": tgt.astype(f32),
        "labels": labels.astype(f32),
        "gt_trans": T.astype(f32),
        "p_image": rng.random((H, W, 3), dtype=f32),
        "q_image": rng.random((H, W, 3), dtype=f32),
    }


def pool(mix, seed):
    """The pool of requests: a list of ``pool_requests`` lists of
    ``pairs_per_request`` pairs."""
    rng = np.random.default_rng([seed, 1])
    count = mix["pool_requests"] * mix["pairs_per_request"]
    lo, hi = mix["valid"]
    valid = np.floor(spaced(lo, hi + 1, count, rng)).astype(int)
    valid = np.minimum(valid, hi)
    ratio = spaced(*mix["inlier_ratio"], count, rng)
    pairs = [make_pair(rng, mix, v, r) for v, r in zip(valid, ratio)]
    per = mix["pairs_per_request"]
    return [pairs[i:i + per] for i in range(0, count, per)]


def arrivals(mix, seed, seconds, rate=None):
    """Open-loop arrival times in seconds from the start, every one before
    ``seconds``: about ``rate`` x ``seconds`` arrivals (the mix's rate, or
    ``rate``) whose gaps are exponential, as a Poisson process's are.
    Every seed gets the same multiset of gaps (the exponential's quantiles
    at evenly spaced levels, scaled to the mean 1 / rate) in its own
    order, so that the offered load does not change with the seed; the
    bursts are the seed's own."""
    spec = mix["arrivals"]
    if spec["process"] != "poisson":
        raise ValueError(f"unknown arrival process {spec['process']!r}")
    rate = spec["rate"] if rate is None else rate
    count = max(1, int(round(rate * seconds)))
    gaps = -np.log(1.0 - (np.arange(count) + 0.5) / count)
    gaps *= count / (rate * gaps.sum())
    rng = np.random.default_rng([seed, 2])
    times = np.cumsum(gaps[rng.permutation(count)])
    return times[times < seconds]
