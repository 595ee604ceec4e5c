"""Putative correspondences from descriptors.

Counterpart of ``gmf_tpu/data/correspondence.py``, the recipe of the
reference's loaders (ThreeDMatch.py:163-217, KITTI.py:95-140): 1-NN in
descriptor space with an optional mutual check, ground-truth labels by
distance under the ground-truth transform, and the ``in_dim``-dependent
``corr_pos`` encoding.

- ``build_correspondences``: host NumPy, one pair, compacted rows.
- ``match_descriptors_device``: batched tensors on the model's device, one
  row per source point with a mask, the registrar's raw-descriptor path.
  It reads nothing back to the host: the fallback below 10 mutual matches
  is a ``torch.where``.
- ``encode_corr_pos``: the encoding alone.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from gmf_tpu_torch.geometry.se3 import transform


def _transform_np(pts, trans):
    """``R p + t`` in f32, as the reference's jnp transform computes it."""
    pts = np.asarray(pts, np.float32)
    trans = np.asarray(trans, np.float32)
    return pts @ trans[:3, :3].T + trans[:3, 3]


def build_correspondences(
    src_keypts: np.ndarray, tgt_keypts: np.ndarray,
    src_desc: np.ndarray, tgt_desc: np.ndarray,
    gt_trans: np.ndarray, inlier_threshold: float,
    use_mutual: bool = True, in_dim: int = 6,
) -> Optional[Dict[str, np.ndarray]]:
    """dict(corr_pos, src_keypts, tgt_keypts, labels, src_desc, tgt_desc)
    of one pair, or None when fewer than 10 matches survive (the reference
    draws another pair then, ThreeDMatch.py:175-177)."""
    distance = np.sqrt(np.maximum(2 - 2 * (src_desc @ tgt_desc.T), 0) + 1e-6)
    source_idx = np.argmin(distance, axis=1)
    if use_mutual:
        target_idx = np.argmin(distance, axis=0)
        mutual = target_idx[source_idx] == np.arange(len(source_idx))
        corr = np.stack([np.where(mutual)[0], source_idx[mutual]], axis=-1)
    else:
        corr = np.stack([np.arange(len(source_idx)), source_idx], axis=-1)
    if len(corr) < 10:
        return None

    frag1 = src_keypts[corr[:, 0]]
    frag2 = tgt_keypts[corr[:, 1]]
    frag1_warp = _transform_np(frag1, gt_trans)
    dist = np.sqrt(np.sum((frag1_warp - frag2) ** 2, axis=1))
    labels = (dist < inlier_threshold).astype(np.float32)

    input_src = src_keypts[corr[:, 0]].astype(np.float32)
    input_tgt = tgt_keypts[corr[:, 1]].astype(np.float32)
    corr_pos = encode_corr_pos(input_src, input_tgt, in_dim,
                               src_desc[corr[:, 0]], tgt_desc[corr[:, 1]])
    return {
        "corr_pos": corr_pos.astype(np.float32),
        "src_keypts": input_src,
        "tgt_keypts": input_tgt,
        "labels": labels,
        "src_desc": src_desc[corr[:, 0]].astype(np.float32),
        "tgt_desc": tgt_desc[corr[:, 1]].astype(np.float32),
    }


def match_descriptors_device(src_keypts, tgt_keypts, src_desc, tgt_desc,
                             gt_trans, inlier_threshold: float,
                             mask_s, mask_t, use_mutual: bool = True,
                             in_dim: int = 6):
    """Putative correspondences of B padded pairs on their device.

    src_keypts [B, Ns, 3], tgt_keypts [B, Nt, 3], src_desc [B, Ns, D],
    tgt_desc [B, Nt, D], gt_trans [B, 4, 4], mask_s [B, Ns] and mask_t
    [B, Nt] (1 for a real point), all f32. One row per source point:
    its 1-NN target (masked targets never win); with ``use_mutual`` a row
    is kept when that target's 1-NN among the real source points is the
    row itself, and a pair with fewer than 10 such rows keeps every real
    row (plain 1-NN, the reference loaders' fallback). Rows not kept are
    masked and zeroed (the LCPE convolution needs zeroed padding).

    Returns dict(corr_pos [B, Ns, in_dim], src_keypts [B, Ns, 3],
    tgt_keypts [B, Ns, 3], labels [B, Ns], corr_mask [B, Ns], src_idx
    [B, Ns] int32, the matched target of every row), the host builder's
    rows uncompacted. ``in_dim``: 3, 6, 9 or 6 + 2 D (the reference's 70
    for 32-d descriptors).
    """
    ns = src_desc.shape[1]
    sim = torch.matmul(src_desc, tgt_desc.transpose(-1, -2))
    dist = torch.sqrt(torch.clamp(2.0 - 2.0 * sim, min=0.0) + 1e-6)
    dist = dist + 1e9 * (1.0 - mask_t)[:, None, :]
    src_idx = dist.argmin(-1)
    if use_mutual:
        tgt_idx = (dist + 1e9 * (1.0 - mask_s)[:, :, None]).argmin(1)
        mutual = (torch.gather(tgt_idx, 1, src_idx)
                  == torch.arange(ns, device=src_idx.device)).float()
        mutual_mask = mask_s * mutual
        corr_mask = torch.where(mutual_mask.sum(-1, keepdim=True) >= 10,
                                mutual_mask, mask_s)
    else:
        corr_mask = mask_s

    tgt_sel = torch.gather(tgt_keypts, 1, src_idx[..., None].expand(-1, -1, 3))
    warped = transform(src_keypts, gt_trans)
    d = torch.sqrt(((warped - tgt_sel) ** 2).sum(-1))
    labels = (d < inlier_threshold).float() * corr_mask

    cm = corr_mask[..., None]
    src_sel = src_keypts * cm
    tgt_sel = tgt_sel * cm

    def centred(pos):
        mean = pos.sum(1, keepdim=True) / torch.clamp(
            corr_mask.sum(-1), min=1.0)[:, None, None]
        return (pos - mean) * cm

    if in_dim == 3:
        corr_pos = src_sel - tgt_sel
    elif in_dim == 6:
        corr_pos = centred(torch.cat([src_sel, tgt_sel], -1))
    elif in_dim == 9:
        corr_pos = torch.cat([src_sel, tgt_sel, src_sel - tgt_sel], -1)
    elif in_dim == 6 + 2 * src_desc.shape[-1]:  # the reference's in_dim 70
        tgt_desc_sel = torch.gather(
            tgt_desc, 1, src_idx[..., None].expand(-1, -1, tgt_desc.shape[-1]))
        corr_pos = torch.cat([centred(torch.cat([src_sel, tgt_sel], -1)),
                              src_desc * cm, tgt_desc_sel * cm], -1)
    else:
        raise ValueError(f"unsupported in_dim {in_dim} for device matching")
    return {
        "corr_pos": corr_pos, "src_keypts": src_sel, "tgt_keypts": tgt_sel,
        "labels": labels, "corr_mask": corr_mask,
        # the host rebuilds the matched rows from its own copies with these
        "src_idx": src_idx.int(),
    }


def encode_corr_pos(src, tgt, in_dim: int, src_desc=None, tgt_desc=None):
    """The in_dim-dependent correspondence encoding (ThreeDMatch.py:
    205-217), host NumPy."""
    if in_dim == 3:
        return src - tgt
    if in_dim == 6:
        pos = np.concatenate([src, tgt], axis=-1)
        return pos - pos.mean(0)
    if in_dim == 9:
        return np.concatenate([src, tgt, src - tgt], axis=-1)
    if in_dim == 70:
        pos = np.concatenate([src, tgt], axis=-1)
        pos = pos - pos.mean(0)
        return np.concatenate([pos, src_desc, tgt_desc], axis=-1)
    raise ValueError(f"unsupported in_dim {in_dim}")
