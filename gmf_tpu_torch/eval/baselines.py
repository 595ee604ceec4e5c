"""The classical outlier-rejection baselines under the evaluation harness.

Counterpart of ``gmf_tpu/eval/baselines.py`` (GMF_PointDSC/
baseline_scripts/baseline_3DMatch.py and baseline_KITTI.py): spectral
matching (SM, :19-54), maximum clique (PMC, :56-78), RANSAC (:80-100)
and GC-RANSAC (:101-125). Each ``*_register`` returns (trans [4, 4],
labels [N]) as NumPy, what ``eval/harness.py`` scores.

- SM on the device: the [N, N] length consistency row block by row
  block from per-coordinate differences (never gmf_tpu's [N, N, 6]
  differences, 3.5 GB in f32 at KITTI's N = 12000), the power iteration,
  the top 10% and the eigenvector-weighted Kabsch (``geometry/
  {spectral,kabsch}.py``).
- PMC: the consistency graph on the host in NumPy, as gmf_tpu builds it
  (so the edge list is the same), the clique by the native solver
  (``utils/max_clique.py``), the Kabsch on the device.
- RANSAC on the device (``geometry/ransac.py``), its draws from a
  ``torch.Generator`` seeded with ``seed``.
- GC-RANSAC by the pygcransac wheel where it is installed, else by the
  native solver (``utils/gcransac.py``).

``make_baseline_register_fn`` raises ``BaselineUnavailable`` when a
method's dependency is missing (GC-RANSAC with neither the wheel nor a
C++ compiler), so that a command line can log the method as skipped; it
builds PMC's and GC-RANSAC's native library then, and a failed build
raises.
"""

from __future__ import annotations

import os
import shutil
from typing import Dict, Tuple

import numpy as np
import torch

from gmf_tpu_torch.geometry.kabsch import rigid_transform_3d
from gmf_tpu_torch.geometry.ransac import ransac_registration
from gmf_tpu_torch.geometry.spectral import leading_eigenvector_fixed
from gmf_tpu_torch.utils.device import resolve_device

BASELINE_METHODS = ("SM", "PMC", "RANSAC", "GCRANSAC")
SM_ROW_BLOCK = 2048  # rows of the [N, N] consistency formed at a time


class BaselineUnavailable(RuntimeError):
    """A baseline's external dependency is missing."""


def _pygcransac_available() -> bool:
    try:
        import pygcransac  # noqa: F401
        return True
    except ImportError:
        return False


def gcransac_available() -> bool:
    """GC-RANSAC can run: the pygcransac wheel is installed, or a C++
    compiler is there to build the native solver."""
    return (_pygcransac_available()
            or shutil.which(os.environ.get("CXX", "g++")) is not None)


def _as(x, device):
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def length_consistency(corr, row_block: int = SM_ROW_BLOCK):
    """[N, N]: ||s_i - s_j|| - ||t_i - t_j|| of correspondences corr
    [N, 6] (source xyz, target xyz), each norm the root of its summed
    squared coordinate differences, ``row_block`` rows at a time."""
    n = corr.shape[0]
    out = torch.empty(n, n, dtype=corr.dtype, device=corr.device)
    for r0 in range(0, n, row_block):
        rows = corr[r0:r0 + row_block]
        lengths = []
        for side in (0, 3):
            sq = 0
            for c in range(side, side + 3):
                sq = sq + (rows[:, None, c] - corr[None, :, c]) ** 2
            lengths.append(torch.sqrt(sq))
        out[r0:r0 + row_block] = lengths[0] - lengths[1]
    return out


def sm_register(corr_pos, src_keypts, tgt_keypts, inlier_threshold: float,
                top_ratio: float = 0.1, device=None
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Spectral matching (ref :19-54): compatibility max(0, 4.5 - d^2 /
    (2 sigma^2)) with sigma = tau / 3 and a zero diagonal, 10 power
    iterations, the top ``top_ratio`` of the eigenvector as inliers, the
    eigenvector-weighted Kabsch."""
    dev = resolve_device(device)
    d = length_consistency(_as(corr_pos, dev))
    sigma = inlier_threshold / 3.0
    M = torch.clamp(4.5 - d ** 2 / (2 * sigma ** 2), min=0.0)
    M.fill_diagonal_(0.0)
    del d
    eig = leading_eigenvector_fixed(M[None], num_iters=10)[0]
    del M
    k = max(int(eig.shape[0] * top_ratio), 1)
    top = torch.argsort(-eig, stable=True)[:k]
    labels = torch.zeros_like(eig)
    labels[top] = 1.0
    trans = rigid_transform_3d(_as(src_keypts, dev)[None],
                               _as(tgt_keypts, dev)[None],
                               (eig * labels)[None])[0]
    return trans.cpu().numpy(), labels.cpu().numpy()


def consistency_edges(corr_pos, inlier_threshold: float):
    """PMC's graph on the host, as gmf_tpu builds it: an edge (i < j)
    where |d_src^2 - d_tgt^2| < tau, the squared lengths summed over the
    coordinates' squared differences. Returns (ei, ej) int32."""
    corr = np.asarray(corr_pos)
    s, t = corr[:, 0:3], corr[:, 3:6]
    ds = ((s[:, None] - s[None]) ** 2).sum(-1)
    dt = ((t[:, None] - t[None]) ** 2).sum(-1)
    ok = np.abs(ds - dt) < inlier_threshold
    np.fill_diagonal(ok, False)
    ei, ej = np.where(np.triu(ok, 1))
    return ei.astype(np.int32), ej.astype(np.int32)


def pmc_register(corr_pos, src_keypts, tgt_keypts, inlier_threshold: float,
                 device=None) -> Tuple[np.ndarray, np.ndarray]:
    """Maximum clique (ref :56-78): the consistency graph
    (``consistency_edges``), its maximum clique by the native solver,
    the uniform-weight Kabsch on the clique."""
    from gmf_tpu_torch.utils.max_clique import pmc

    dev = resolve_device(device)
    n = len(corr_pos)
    ei, ej = consistency_edges(corr_pos, inlier_threshold)
    clique = pmc(ei, ej, n, len(ei))
    labels = np.zeros(n, np.float32)
    labels[clique] = 1.0
    trans = rigid_transform_3d(_as(src_keypts, dev)[None],
                               _as(tgt_keypts, dev)[None],
                               _as(labels, dev)[None])[0]
    return trans.cpu().numpy(), labels


def ransac_register(src_keypts, tgt_keypts, inlier_threshold: float,
                    max_iteration: int = 5000, seed: int = 0, device=None
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """RANSAC on the correspondences (ref :80-100)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    T, inliers, _ = ransac_registration(
        gen, _as(src_keypts, dev), _as(tgt_keypts, dev),
        inlier_threshold=inlier_threshold, num_iters=max_iteration)
    return T.cpu().numpy(), inliers.to(torch.float32).cpu().numpy()


def gcransac_register(src_keypts, tgt_keypts, inlier_threshold: float,
                      max_iteration: int = 5000
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """GC-RANSAC (ref :101-125): the pygcransac wheel where installed
    (the reference's exact dependency), else the native solver with the
    same call (conf 0.99999999, spatial coherence 0.1). No inlier gives
    the identity."""
    src = np.asarray(src_keypts, np.float64)
    tgt = np.asarray(tgt_keypts, np.float64)
    if _pygcransac_available():
        import pygcransac

        pose, mask = pygcransac.findRigidTransform(
            src, tgt, threshold=inlier_threshold, conf=0.99999999,
            spatial_coherence_weight=0.1, max_iters=max_iteration,
            use_sprt=True, min_inlier_ratio_for_sprt=0.1)
        if mask.sum() == 0:
            pose = np.eye(4)
        return pose.T.astype(np.float32), np.asarray(mask, np.float32)

    from gmf_tpu_torch.utils.gcransac import gcransac_rigid

    pose, mask = gcransac_rigid(src, tgt, threshold=inlier_threshold,
                                spatial_coherence_weight=0.1,
                                max_iters=max_iteration)
    if mask.sum() == 0:
        pose = np.eye(4, dtype=np.float32)
    return pose, mask


def make_baseline_register_fn(method: str, inlier_threshold: float = 0.10,
                              max_iteration: int = 5000, device=None):
    """The harness's ``register_fn(pair)`` for a named baseline, on
    ``device`` (default the card). Raises ``ValueError`` for an unknown
    method and ``BaselineUnavailable`` for a missing dependency, at
    construction; builds the native library a method needs then."""
    method = method.upper()
    if method not in BASELINE_METHODS:
        raise ValueError(f"unknown baseline {method!r}; one of "
                         f"{BASELINE_METHODS}")
    dev = resolve_device(device)
    if method == "GCRANSAC":
        if not gcransac_available():
            raise BaselineUnavailable(
                "GC-RANSAC needs the pygcransac wheel or a C++ compiler "
                "to build the native solver (cpp/gcransac)")
        if not _pygcransac_available():
            from gmf_tpu_torch.utils.gcransac import library_path

            library_path()
    elif method == "PMC":
        from gmf_tpu_torch.utils.max_clique import library_path

        library_path()

    def register(pair: Dict[str, np.ndarray]):
        if method == "SM":
            return sm_register(pair["corr_pos"], pair["src_keypts"],
                               pair["tgt_keypts"], inlier_threshold,
                               device=dev)
        if method == "PMC":
            return pmc_register(pair["corr_pos"], pair["src_keypts"],
                                pair["tgt_keypts"], inlier_threshold,
                                device=dev)
        if method == "RANSAC":
            return ransac_register(pair["src_keypts"], pair["tgt_keypts"],
                                   inlier_threshold, max_iteration,
                                   device=dev)
        return gcransac_register(pair["src_keypts"], pair["tgt_keypts"],
                                 inlier_threshold, max_iteration)

    return register
