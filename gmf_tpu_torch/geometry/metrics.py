"""Registration and classification metrics.

Counterpart of ``gmf_tpu/geometry/metrics.py``, the part the training
losses use.
"""

from __future__ import annotations


def precision_recall_f1(pred, gt, eps: float = 1e-8):
    """Binary classification precision, recall and F1 over the last axis,
    on the device (no host round trip). The caller zeroes masked entries."""
    pred = pred.float()
    gt = gt.float()
    tp = (pred * gt).sum(-1)
    precision = tp / (pred.sum(-1) + eps)
    recall = tp / (gt.sum(-1) + eps)
    f1 = 2 * precision * recall / (precision + recall + eps)
    return precision, recall, f1
