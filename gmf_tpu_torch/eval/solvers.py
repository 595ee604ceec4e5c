"""Eval-time solver variants: the model's transform, a RANSAC post-filter,
an ICP polish.

Counterpart of ``gmf_tpu/eval/solvers.py`` (reference:
GMF_PointDSC/evaluation/test_3DMatch.py:71-96): the model's predicted
inliers can feed a RANSAC in place of the model's own transform
('RANSAC', 5000 hypotheses on the predicted-inlier correspondences), and
an ICP can polish the result (evaluation/benchmark_utils.py:40-56). Both
run in PyTorch on the registrar's device (``geometry/ransac.py``,
``geometry/icp.py``); RANSAC draws from a generator seeded 0 for every
pair, as the reference's key.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from gmf_tpu_torch.geometry.icp import icp_refine
from gmf_tpu_torch.geometry.ransac import ransac_registration


def make_register_fn(registrar: Callable, solver: str = "SVD",
                     use_icp: bool = False, inlier_threshold: float = 0.10,
                     ransac_iters: int = 5000) -> Callable:
    """Wrap a registrar with the solver/ICP options.

    The returned callable forwards the registrar's ``register_batch``,
    ``eval_bucket`` and ``dispatch_batch``/``fetch_batch`` (the post-steps
    run at fetch time), which the harness batches and pipelines through.
    """
    if solver not in ("SVD", "RANSAC"):
        raise ValueError(f"unknown solver {solver!r}")
    device = registrar.device

    def tensor(x):
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
            device)

    def _post(pair: Dict[str, np.ndarray], trans, labels):
        if solver == "RANSAC":
            # on the predicted inliers (ref :75-93); the mask keeps shapes
            keep = labels > 0
            if keep.sum() >= 3:
                gen = torch.Generator(device=device).manual_seed(0)
                T, inl, _ = ransac_registration(
                    gen, tensor(pair["src_keypts"][: len(labels)]),
                    tensor(pair["tgt_keypts"][: len(labels)]),
                    inlier_threshold=inlier_threshold,
                    num_iters=ransac_iters, mask=tensor(keep))
                trans = T.cpu().numpy()
                labels = inl.cpu().numpy().astype(np.float32)
        if use_icp:
            # the reference's icp_refine: a 0.10 correspondence distance
            # whatever the dataset's threshold, o3d's default 30
            # iterations (benchmark_utils.py:52-54)
            trans = icp_refine(tensor(pair["src_keypts"]),
                               tensor(pair["tgt_keypts"]), tensor(trans),
                               max_corr_dist=0.10, num_iters=30
                               ).cpu().numpy()
        return trans, labels

    def register(pair: Dict[str, np.ndarray]):
        trans, labels = registrar(pair)
        return _post(pair, trans, labels)

    def register_batch(pairs):
        results = registrar.register_batch(list(pairs))
        return [_post(p, t, lab) for p, (t, lab) in zip(pairs, results)]

    def dispatch_batch(pairs):
        pairs = list(pairs)
        return pairs, registrar.dispatch_batch(pairs)

    def fetch_batch(handle):
        pairs, h = handle
        results = registrar.fetch_batch(h)
        return [_post(p, t, lab) for p, (t, lab) in zip(pairs, results)]

    register.register_batch = register_batch
    register.eval_bucket = registrar.eval_bucket
    register.dispatch_batch = dispatch_batch
    register.fetch_batch = fetch_batch
    return register
