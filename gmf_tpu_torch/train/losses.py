"""PointDSC training losses.

Counterpart of the PointDSC part of ``gmf_tpu/train/losses.py``
(reference: GMF_PointDSC/libs/loss.py): the transformation loss with the
registration metrics, the balanced classification loss with precision,
recall and F1, and the balanced spectral-matching loss. Batched, mask
aware, on the device. The DGR losses (GMF_DGR core/loss.py): the inlier
net's BCE, plain and balanced, and ``high_dim_smooth_l1_loss`` (the SE(3)
refinement's objective).

In a step sharded over a mesh (``parallel.sharded``) each rank passes its
slice of the batch, and the PointDSC losses divide by the global counts
and means, as gmf_tpu's sharded step does: each rank's loss is then the
global loss, whose gradient reaches only that rank's part
(``parallel/collectives.py``), and the metrics are the global batch's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from gmf_tpu_torch.geometry.se3 import decompose_trans, transform
from gmf_tpu_torch.parallel.collectives import batch_mean, batch_sum


def transformation_loss(trans, gt_trans, src_keypts, tgt_keypts, probs,
                        re_thresh: float = 15.0, te_thresh: float = 30.0,
                        mask=None):
    """MSE of the warped keypoints, and the registration metrics.

    trans, gt_trans [B, 4, 4]; keypoints [B, N, 3]; probs [B, N], the
    predicted inlier logits (a pair with no positive one has loss 0);
    re_thresh in degrees, te_thresh in cm. Returns a dict of batch means:
    loss, recall_pct, re_deg, te_cm, rmse (the per-pair RMSE, as the
    reference intended it).
    """
    R, t = decompose_trans(trans)
    gt_R, gt_t = decompose_trans(gt_trans)
    tr = (R * gt_R).sum((-2, -1))  # trace(R^T gt_R)
    re = torch.rad2deg(torch.arccos(torch.clamp((tr - 1.0) / 2.0, -1.0,
                                                1.0)))
    te = torch.linalg.vector_norm(t[..., 0] - gt_t[..., 0], dim=-1) * 100.0

    sq = ((transform(src_keypts, trans) - tgt_keypts) ** 2).sum(-1)
    d = torch.sqrt(sq + 1e-12)
    if mask is not None:
        denom = mask.sum(-1) + 1e-6
        mse = (sq * mask).sum(-1) / denom
        rmse = (d * mask).sum(-1) / denom
        has_inlier = ((probs > 0) * mask).sum(-1) > 0
    else:
        mse = sq.mean(-1)
        rmse = d.mean(-1)
        has_inlier = (probs > 0).sum(-1) > 0
    loss = torch.where(has_inlier, mse, torch.zeros_like(mse))
    success = (re < re_thresh) & (te < te_thresh)
    return {
        "loss": batch_mean(loss),
        "recall_pct": batch_mean(success.float()) * 100.0,
        "re_deg": batch_mean(re),
        "te_cm": batch_mean(te),
        "rmse": batch_mean(rmse),
    }


def classification_loss(pred, gt, balanced: bool = True, weight=None,
                        mask=None):
    """BCE-with-logits on the inlier logits, and precision, recall and F1
    of ``pred > 0``.

    ``balanced`` (the default): the positive class weight is #neg / #pos
    with the reference's relu(x - 1) + 1 floors on both counts. Otherwise
    the plain BCE, each entry times ``weight`` where one is given (which
    then takes precedence, as in gmf_tpu). Returns dict(loss, precision,
    recall, f1, logit_true, logit_false).
    """
    gt = gt.to(pred.dtype)
    m = torch.ones_like(gt) if mask is None else mask.to(pred.dtype)
    gm = gt * m
    gn = (1.0 - gt) * m
    if weight is not None:
        per = _bce_with_logits(pred, gt) * weight
    elif not balanced:
        per = _bce_with_logits(pred, gt)
    else:
        num_pos = F.relu(batch_sum(gm.sum()) - 1.0) + 1.0
        num_neg = F.relu(batch_sum(gn.sum()) - 1.0) + 1.0
        per = -(num_neg / num_pos * gt * F.logsigmoid(pred)
                + (1.0 - gt) * F.logsigmoid(-pred))
    loss = batch_sum((per * m).sum()) / batch_sum(m.sum())

    # precision, recall and F1 of the flattened labels (counts: exact)
    pred_labels = (pred > 0).float() * m.float()
    tp = batch_sum((pred_labels * gm.float()).sum())
    precision = tp / (batch_sum(pred_labels.sum()) + 1e-8)
    recall = tp / (batch_sum(gm.float().sum()) + 1e-8)
    f1 = 2 * precision * recall / (precision + recall + 1e-8)
    logit_true = batch_sum((pred * gm).sum()) / torch.clamp(
        batch_sum(gm.sum()), min=1.0)
    logit_false = batch_sum((pred * gn).sum()) / torch.clamp(
        batch_sum(gn.sum()), min=1.0)
    return {
        "loss": loss,
        "precision": precision,
        "recall": recall,
        "f1": f1,
        "logit_true": logit_true,
        "logit_false": logit_false,
    }


def spectral_matching_loss(M, gt_labels, balanced: bool = True, mask=None):
    """MSE between the feature-similarity matrix M [B, N, N] and the
    ground-truth inlier outer product (zero diagonal).

    ``balanced`` (the default): half the mean over the positive cells and
    half over the negative ones, whose denominator counts the diagonal
    cells as the reference's does (libs/loss.py:133-134; M's diagonal is
    zero, so only the count changes). Otherwise the plain mean over every
    (unmasked) cell, the reference's ``MSELoss`` (libs/loss.py:137).
    """
    gt = gt_labels.to(M.dtype)
    N = gt.shape[-1]
    gt_M = gt[:, None, :] * gt[:, :, None]
    gt_M = gt_M * (1.0 - torch.eye(N, dtype=M.dtype, device=M.device))
    pair = (torch.ones_like(gt_M) if mask is None
            else mask[:, None, :] * mask[:, :, None])
    gt_M = gt_M * pair
    if not balanced:
        return (batch_sum((((M - gt_M) ** 2) * pair).sum())
                / batch_sum(pair.sum()))
    pos = ((M - 1.0) ** 2 * gt_M).sum((-2, -1))
    npos = F.relu(gt_M.sum((-2, -1)) - 1.0) + 1.0
    neg_M = (1.0 - gt_M) * pair
    neg = (M ** 2 * neg_M).sum((-2, -1))
    nneg = F.relu(neg_M.sum((-2, -1)) - 1.0) + 1.0
    return batch_mean(0.5 * pos / npos + 0.5 * neg / nneg)


def _bce_with_logits(logits, labels):
    """BCE with logits as gmf_tpu's ``_bce_with_logits``:
    -(y log sigmoid(x) + (1 - y) log(1 - sigmoid(x))) by softplus."""
    return -(labels * -F.softplus(-logits)
             + (1.0 - labels) * -F.softplus(logits))


def unbalanced_bce_loss(logits, labels, mask=None):
    """Mean BCE with logits, over the mask's rows when one is given
    (core/loss.py:13-20)."""
    per = _bce_with_logits(logits, labels.to(logits.dtype))
    if mask is not None:
        return (per * mask).sum() / (mask.sum() + 1e-6)
    return per.mean()


def balanced_bce_loss(logits, labels, mask=None):
    """0.5 * mean(BCE | positives) + 0.5 * mean(BCE | negatives), each
    count floored at 1 (core/loss.py:23-39)."""
    labels = labels.to(logits.dtype)
    m = torch.ones_like(labels) if mask is None else mask.to(logits.dtype)
    per = _bce_with_logits(logits, labels)
    pos_m = labels * m
    neg_m = (1.0 - labels) * m
    pos = (per * pos_m).sum() / torch.clamp(pos_m.sum(), min=1.0)
    neg = (per * neg_m).sum() / torch.clamp(neg_m.sum(), min=1.0)
    return 0.5 * pos + 0.5 * neg


def high_dim_smooth_l1_loss(pred, target, weights=None,
                            quantization_size: float = 1.0,
                            eps: float = 1.1920929e-07, mask=None):
    """Smooth-L1 on the FULL squared point distance (GMF_DGR
    core/loss.py:42-61): with sq = ||(X - Y) / q||^2, 0.5 * sq when sq < 1,
    else 0.5 * sqrt(sq) - 0.25; a weighted mean over sum(w)."""
    sq = (((pred - target) / quantization_size) ** 2).sum(-1)
    half = 0.5 * (sq < 1.0).to(pred.dtype)
    per = (0.5 - half) * (torch.sqrt(sq + eps) - 0.5) + half * sq
    if weights is not None:
        w = weights if mask is None else weights * mask
        return (per * w).sum() / (weights.sum() + 1e-12)
    if mask is not None:
        return (per * mask).sum() / (mask.sum() + 1e-6)
    return per.mean()
