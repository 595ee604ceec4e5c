"""Contrastive FCGF descriptor training (hardest-contrastive loss).

Counterpart of ``gmf_tpu/train/descriptor.py``. The reference pipelines
load FCGF weights trained elsewhere with FCGF's hardest-contrastive
objective; this trains them:

- a fixed-size positive sample (``n_pos`` ground-truth voxel pairs,
  mask-padded), drawn with gmf_tpu's ``rng.choice``;
- in-batch hardest negatives with a spatial exclusion radius (a
  candidate within ``exclude_radius`` of the anchor's true partner is not
  a negative: neighbouring voxels share features);
- FCGF's margins on unit features, squared hinges on both sides:
  positives pulled inside ``pos_margin`` (0.1), hardest negatives pushed
  past ``neg_margin`` (1.4);
- both directions a pair, the batch statistics threaded from cloud 0's
  forward into cloud 1's, and one Adam update a pair.

Each cloud's conv1 map takes the net's own kernel size (gmf_tpu's
trainer builds 3^3 whatever the net's kernel).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from gmf_tpu_torch.train.dgr_trainer import pyramid_arrays
from gmf_tpu_torch.train.trainer import floats
from gmf_tpu_torch.utils.device import resolve_device


def hardest_contrastive_loss(f0, f1, pos0, pos1, pos_mask, xyz1,
                             pos_margin: float = 0.1,
                             neg_margin: float = 1.4,
                             exclude_radius: float = 0.1):
    """FCGF hardest-contrastive loss on one direction's positive set.

    Args:
      f0, f1: [cap0, C], [cap1, C] voxel features (pad rows arbitrary).
      pos0, pos1: [P] row indices of corresponding voxels (pad entries
        may repeat row 0).
      pos_mask: [P] 1.0 for real positives.
      xyz1: [cap1, 3] metric voxel centres for the spatial exclusion.
      exclude_radius: candidates within this distance of the anchor's
        true partner are not negatives.

    Returns (loss, metrics dict); the other direction swaps the clouds.
    """
    a = f0[pos0.long()]                # [P, C] anchors
    b = f1[pos1.long()]                # [P, C] true partners
    d_pos = torch.sqrt(((a - b) ** 2).sum(-1) + 1e-12)

    # in-batch negative candidates: the OTHER positives' partners
    D = torch.sqrt(torch.clamp(
        (a ** 2).sum(-1)[:, None] + (b ** 2).sum(-1)[None, :]
        - 2.0 * (a @ b.T), min=0.0) + 1e-12)          # [P, P]
    p1 = xyz1[pos1.long()]             # [P, 3] partner positions
    spat = torch.sqrt(((p1[:, None, :] - p1[None, :, :]) ** 2).sum(-1)
                      + 1e-12)
    valid = (pos_mask[None, :] > 0) & (spat > exclude_radius)
    D = torch.where(valid, D, torch.full_like(D, float("inf")))
    d_neg = D.min(dim=1).values        # hardest negative per anchor
    has_neg = torch.isfinite(d_neg) & (pos_mask > 0)
    d_neg = torch.where(has_neg, d_neg, torch.full_like(d_neg, neg_margin))

    w = pos_mask / torch.clamp(pos_mask.sum(), min=1.0)
    wn = has_neg.to(f0.dtype)
    wn = wn / torch.clamp(wn.sum(), min=1.0)
    loss_pos = (w * torch.clamp(d_pos - pos_margin, min=0.0) ** 2).sum()
    loss_neg = (wn * torch.clamp(neg_margin - d_neg, min=0.0) ** 2).sum()
    loss = loss_pos + loss_neg
    metrics = {
        "d_pos": (w * d_pos).sum(),
        "d_neg": (wn * d_neg).sum(),
        "loss_pos": loss_pos,
        "loss_neg": loss_neg,
    }
    return loss, metrics


class ContrastiveDescriptorTrainer:
    """Hardest-contrastive training of the sparse FCGF ResUNet ``fcgf``
    (the port's net with its weights, moved to ``device``) with Adam."""

    def __init__(self, fcgf, voxel_size: float = 0.05, granule: int = 256,
                 n_pos: int = 128, lr: float = 1e-2, pos_margin: float = 0.1,
                 neg_margin: float = 1.4, exclude_radius_mult: float = 2.0,
                 device_maps: Optional[bool] = None, device=None):
        self.device = resolve_device(device)
        self.fcgf = fcgf.to(self.device)
        self.voxel_size = voxel_size
        self.granule = granule
        self.n_pos = n_pos
        self.pos_margin = pos_margin
        self.neg_margin = neg_margin
        self.exclude_radius = exclude_radius_mult * voxel_size
        self.device_maps = (self.device.type != "cpu" if device_maps is None
                            else device_maps)
        # optax.adam(lr): b1 0.9, b2 0.999, eps 1e-8, no decay
        self.optimizer = torch.optim.Adam(self.fcgf.parameters(), lr=lr,
                                          eps=1e-8)

    # -- host prep -----------------------------------------------------

    def prep_pair(self, pair: Dict[str, np.ndarray], rng=None):
        """Both pyramids and a fixed-size positive sample for one pair."""
        rng = rng or np.random
        dev = self.device
        pyr0, pyr1 = (pyramid_arrays(pair[k], self.fcgf.conv1_kernel_size,
                                     self.granule, self.device_maps, dev)
                      for k in ("coords0", "coords1"))
        cap0 = int(pyr0["mask_0"].shape[0])
        cap1 = int(pyr1["mask_0"].shape[0])
        xyz0 = np.zeros((cap0, 3), np.float32)
        xyz0[: len(pair["pcd0"])] = pair["pcd0"]
        xyz1 = np.zeros((cap1, 3), np.float32)
        xyz1[: len(pair["pcd1"])] = pair["pcd1"]

        matches = np.asarray(pair["correspondences"])
        P = self.n_pos
        pos0 = np.zeros(P, np.int64)
        pos1 = np.zeros(P, np.int64)
        mask = np.zeros(P, np.float32)
        if min(len(matches), P):
            sel = (rng.choice(len(matches), P, replace=False)
                   if len(matches) > P else np.arange(len(matches)))
            pos0[: len(sel)] = matches[sel, 0]
            pos1[: len(sel)] = matches[sel, 1]
            mask[: len(sel)] = 1.0

        def t(x):
            return torch.as_tensor(x, device=dev)

        return dict(pyr0=pyr0, pyr1=pyr1, pos0=t(pos0), pos1=t(pos1),
                    mask=t(mask), xyz0=t(xyz0), xyz1=t(xyz1))

    # -- the step -------------------------------------------------------

    def step(self, p) -> Dict[str, torch.Tensor]:
        """Loss of both directions on a prepared pair (the net in train
        mode, cloud 1's forward after cloud 0's statistics update), its
        gradient and one Adam update. Returns the metric tensors."""
        self.fcgf.train()
        f0, f1 = (self.fcgf(torch.ones(pyr["mask_0"].shape[0], 1,
                                       device=self.device), pyr)
                  for pyr in (p["pyr0"], p["pyr1"]))
        kw = dict(pos_margin=self.pos_margin, neg_margin=self.neg_margin,
                  exclude_radius=self.exclude_radius)
        loss, metrics = hardest_contrastive_loss(
            f0, f1, p["pos0"], p["pos1"], p["mask"], p["xyz1"], **kw)
        # reverse direction: anchors in cloud 1, partners (and the spatial
        # exclusion's positions) in cloud 0
        loss_r, _ = hardest_contrastive_loss(
            f1, f0, p["pos1"], p["pos0"], p["mask"], p["xyz0"], **kw)
        total = loss + loss_r
        self.optimizer.zero_grad(set_to_none=True)
        total.backward()
        for w in self.fcgf.parameters():
            if w.grad is None:  # optax moves every parameter
                w.grad = torch.zeros_like(w)
        self.optimizer.step()
        return dict(metrics, loss=total)

    def train_pair(self, pair: Dict[str, np.ndarray], rng=None):
        return floats(self.step(self.prep_pair(pair, rng)))
