"""Registration and classification metrics.

Counterpart of ``gmf_tpu/geometry/metrics.py``: rotation and translation
errors (GMF_DGR core/metrics.py:25-43, GMF_PointDSC libs/loss.py:18-63),
the success test a benchmark reads (3DMatch 15 deg / 0.30 m, KITTI 5 deg
/ 0.60 m), DGR's correspondence distance and precision/recall/F1. Products
run in full f32 (TF32 off, ``utils/device.py``), as gmf_tpu's HIGHEST.
"""

from __future__ import annotations

import torch

def rotation_error_deg(R_pred, R_gt, eps: float = 1e-7):
    """Geodesic rotation error in degrees between [..., 3, 3] rotations:
    acos((trace(R_p^T R_g) - 1) / 2), the cosine clamped to
    [-1 + eps, 1 - eps] as in the reference."""
    tr = (R_pred * R_gt).sum((-1, -2))
    cos = ((tr - 1.0) / 2.0).clamp(-1.0 + eps, 1.0 - eps)
    return torch.rad2deg(torch.arccos(cos))

def translation_error(t_pred, t_gt):
    """L2 error between [..., 3] (or [..., 3, 1]) translations."""
    d = t_pred.squeeze(-1) if t_pred.shape[-1] == 1 else t_pred
    g = t_gt.squeeze(-1) if t_gt.shape[-1] == 1 else t_gt
    return torch.linalg.vector_norm(d - g, dim=-1)

def registration_success(trans_pred, trans_gt, re_thresh_deg: float,
                         te_thresh: float):
    """(RE < re_thresh and TE < te_thresh [...], RE in degrees [...], TE
    [...]) for [..., 4, 4] transforms."""
    re = rotation_error_deg(trans_pred[..., :3, :3], trans_gt[..., :3, :3])
    te = translation_error(trans_pred[..., :3, 3], trans_gt[..., :3, 3])
    return (re < re_thresh_deg) & (te < te_thresh), re, te

def corr_dist(T, xyz0, xyz1, weight=None, max_dist: float | None = None):
    """Mean (or ``weight``-weighted) distance between T(xyz0) and the
    paired rows of xyz1, each clipped at ``max_dist`` if given
    (GMF_DGR core/metrics.py:53-59)."""
    warped = (torch.matmul(xyz0, T[..., :3, :3].transpose(-1, -2))
              + T[..., None, :3, 3])
    d = torch.linalg.vector_norm(warped - xyz1, dim=-1)
    if max_dist is not None:
        d = d.clamp(max=max_dist)
    if weight is not None:
        return (d * weight).sum(-1) / (weight.sum(-1) + 1e-6)
    return d.mean(-1)

def precision_recall_f1(pred, gt, mask=None, eps: float = 1e-8):
    """Binary classification precision, recall and F1 over the last axis,
    on the device (no host round trip); entries where ``mask`` is 0 count
    as neither predicted nor true."""
    pred = pred.float()
    gt = gt.float()
    if mask is not None:
        m = mask.float()
        pred, gt = pred * m, gt * m
    tp = (pred * gt).sum(-1)
    precision = tp / (pred.sum(-1) + eps)
    recall = tp / (gt.sum(-1) + eps)
    f1 = 2 * precision * recall / (precision + recall + eps)
    return precision, recall, f1
