"""Benchmark utilities: seeding, AUC, Euler conversion, LoMatch protocol.

Counterpart of ``gmf_tpu/eval/benchmark_utils.py``, host NumPy (reference:
GMF_PointDSC/evaluation/benchmark_utils.py, exact_auc :9-24, set_seed
:27-37, rot_to_euler :74-95, and benchmark_utils_predator.py, the
3DLoMatch trajectory IO and the covariance-weighted registration error,
computeTransformationErr :56, evaluate_registration :174). ICP is in
``geometry/icp.py``.
"""

from __future__ import annotations

import math
import random
from typing import Dict, List, Sequence, Tuple

import numpy as np


def set_seed(seed: int = 51):
    """Seed NumPy's, Python's and torch's generators (the card's too)."""
    import torch

    np.random.seed(seed)
    random.seed(seed)
    torch.manual_seed(seed)


def exact_auc(errors, thresholds: Sequence[float]) -> List[float]:
    """Exact area under the recall-vs-error curve at given thresholds."""
    sort_idx = np.argsort(errors)
    errors = np.array(errors, np.float64)[sort_idx]
    recall = (np.arange(len(errors)) + 1) / len(errors)
    errors = np.r_[0.0, errors]
    recall = np.r_[0.0, recall]
    aucs = []
    for t in thresholds:
        last = np.searchsorted(errors, t)
        r = np.r_[recall[:last], recall[last - 1]]
        e = np.r_[errors[:last], t]
        aucs.append(float(np.trapezoid(r, x=e) / t))
    return aucs


def is_rotation_matrix(R: np.ndarray) -> bool:
    return float(np.linalg.norm(np.eye(3) - R.T @ R)) < 1e-3


def rot_to_euler(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> XYZ Euler angles in degrees."""
    assert is_rotation_matrix(R)
    sy = math.sqrt(R[0, 0] ** 2 + R[1, 0] ** 2)
    if sy >= 1e-6:
        x = math.atan2(R[2, 1], R[2, 2])
        y = math.atan2(-R[2, 0], sy)
        z = math.atan2(R[1, 0], R[0, 0])
    else:
        x = math.atan2(-R[1, 2], R[1, 1])
        y = math.atan2(-R[2, 0], sy)
        z = 0.0
    return np.degrees([x, y, z])


# ---------------------------------------------------------------------------
# PREDATOR/3DLoMatch protocol (benchmark_utils_predator.py)
# ---------------------------------------------------------------------------


def compute_transformation_error(trans_est: np.ndarray,
                                 trans_gt: np.ndarray,
                                 info: np.ndarray) -> float:
    """Covariance-weighted transformation error (predator :56):
    p = se3-residual 6-vector, err = p^T Info p / Info[0,0]."""
    rel = np.linalg.inv(trans_gt) @ trans_est
    R, t = rel[:3, :3], rel[:3, 3]
    q = _rot_to_quat(R)
    # predator uses er = [t, 2*q_imag]
    p = np.concatenate([t, -2.0 * q[1:]])
    return float(p.T @ info @ p / info[0, 0])


def _rot_to_quat(R: np.ndarray) -> np.ndarray:
    w = math.sqrt(max(1.0 + R[0, 0] + R[1, 1] + R[2, 2], 0.0)) / 2.0
    if w < 1e-8:
        # fall back through the largest diagonal element
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = math.sqrt(max(1.0 + R[i, i] - R[j, j] - R[k, k], 1e-12)) * 2
        q = np.zeros(4)
        q[0] = (R[k, j] - R[j, k]) / s
        q[1 + i] = s / 4
        q[1 + j] = (R[j, i] + R[i, j]) / s
        q[1 + k] = (R[k, i] + R[i, k]) / s
        return q
    return np.array([
        w,
        (R[2, 1] - R[1, 2]) / (4 * w),
        (R[0, 2] - R[2, 0]) / (4 * w),
        (R[1, 0] - R[0, 1]) / (4 * w),
    ])


def evaluate_registration_rmse(est_pairs: Dict[Tuple[int, int], np.ndarray],
                               gt_pairs: Dict[Tuple[int, int], np.ndarray],
                               gt_info: Dict[Tuple[int, int], np.ndarray],
                               err_thresh: float = 0.04) -> float:
    """3DLoMatch registration recall under the RMSE(<=0.2 m => 0.04 m^2)
    criterion (predator evaluate_registration :174). Only non-consecutive
    gt pairs count, as in the benchmark."""
    good, total = 0, 0
    for key, T_gt in gt_pairs.items():
        i, j = key
        if abs(i - j) <= 1:
            continue
        total += 1
        if key not in est_pairs:
            continue
        err = compute_transformation_error(
            est_pairs[key], T_gt, gt_info.get(key, np.eye(6)))
        if err <= err_thresh:
            good += 1
    return good / max(total, 1)


def read_gt_info(path: str):
    """Read a 3DMatch/PREDATOR ``gt.info`` file: per-pair 6x6 information
    matrices keyed by (i, j) (benchmark_utils_predator.py trajectory-info
    IO)."""
    out = {}
    with open(path) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    i = 0
    while i + 6 < len(lines) or (i + 6 == len(lines) and len(lines) >= 7):
        head = lines[i].split()
        key = (int(head[0]), int(head[1]))
        mat = np.array([[float(x) for x in lines[i + r].split()]
                        for r in range(1, 7)])
        out[key] = mat
        i += 7
    return out


def read_gt_pairs(path: str):
    """Read a ``gt.log`` into {(i, j): 4x4} (same block format as
    trajectories; keys are the header's first two ints)."""
    out = {}
    with open(path) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    i = 0
    while i + 4 < len(lines) or (i + 4 == len(lines) and len(lines) >= 5):
        head = lines[i].split()
        key = (int(head[0]), int(head[1]))
        mat = np.array([[float(x) for x in lines[i + r].split()]
                        for r in range(1, 5)])
        out[key] = mat
        i += 5
    return out
