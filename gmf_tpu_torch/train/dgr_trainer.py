"""WeightedProcrustesTrainer: DGR+GMF training on one device.

Counterpart of ``gmf_tpu/train/dgr_trainer.py`` (reference:
GMF_DGR_fcgf/core/trainer.py:38-699):
- a frozen FCGF descriptor net (eval mode, no gradient) and the trainable
  GMF 6-D inlier net (train mode: masked batch statistics);
- per pair: FCGF on both clouds -> 1-NN pairs -> hash-based correctness
  labels (``generate_inlier_input``) -> the 6-D net with both frames on
  the unique 6-D voxels -> sigmoid weights kept above the clip ->
  weighted Procrustes -> loss = procrustes_w * (rot_err + trans_w *
  trans_err) * [ws > 10] + inlier_w * balanced BCE;
- a pair with a non-finite loss adds no gradient, and a step whose mean
  gradient is not finite updates nothing (ref :259-262, :292-300);
- SGD with momentum (or Adam) after the weight decay, at ``lr *
  exp_gamma ** (applied_steps // steps_per_epoch)``, optax's staircase
  schedule, which counts only applied updates.

The batch-norm statistics run on from pair to pair as the serial JAX loop
threads them, and a pair with a non-finite loss updates them too. Where
the device is not the CPU the kernel maps are built on it
(``sparse/device_maps.py``), as dense pruned maps: the JAX trainer builds
no compacted schedule, and neither does this one. The convolutions then
run ``sparse_conv``, whose backward gathers again what its forward
gathered, so that the backward of the 6-D net fits on the card. Each
net's conv1 map takes the net's own kernel size, as the port's engine
does (gmf_tpu's trainer takes the config's and clamps). The JAX trainer's
data-parallel step (``train_step_dp``) waits for ROADMAP queue 1 item 6.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch

from gmf_tpu_torch.configs.presets import DGRTrainConfig
from gmf_tpu_torch.data.dgr_loader import find_correct_correspondence
from gmf_tpu_torch.geometry.kabsch import kabsch_quat
from gmf_tpu_torch.geometry.knn import nearest_neighbor
from gmf_tpu_torch.models.dgr import inlier_input_features, se3_refine
from gmf_tpu_torch.sparse.device_maps import build_pyramid_arrays_device
from gmf_tpu_torch.sparse.kernel_map import build_pyramid
from gmf_tpu_torch.sparse.resunet import pyramid_to_arrays
from gmf_tpu_torch.sparse.voxelize import sparse_quantize
from gmf_tpu_torch.train.losses import balanced_bce_loss
from gmf_tpu_torch.train.trainer import floats
from gmf_tpu_torch.utils.device import resolve_device, timed_stage


def pyramid_arrays(coords: np.ndarray, conv1_kernel_size: int,
                   granule: int, on_device: bool, device):
    """The dense pruned kernel-map pyramid of ``coords`` as the nets'
    dict on ``device``, built there or on the host (the same maps)."""
    if on_device:
        return build_pyramid_arrays_device(
            coords, 4, conv1_kernel_size=conv1_kernel_size, granule=granule,
            device=device)
    return pyramid_to_arrays(
        build_pyramid(coords, 4, conv1_kernel_size=conv1_kernel_size,
                      granule=granule), device)


class WeightedProcrustesTrainer:
    """DGR+GMF trainer: ``fcgf`` (frozen) and ``inlier`` are the port's
    ``SparseResUNet2`` nets with their weights; both move to ``device``
    (the card unless ``device="cpu"``).

    ``stage_seconds``: when set to a dict, each stage of a pair adds its
    seconds there, the card synchronised at its ends: "descriptors"
    (FCGF pyramids and nets, 1-NN, labels), "pyramid_6d" (6-D
    quantization, the pyramid, the net's input), "forward_backward" and,
    a step, "update".
    """

    def __init__(self, fcgf, inlier, config: Optional[DGRTrainConfig] = None,
                 voxel_cap_granule: int = 512, corr_cap_granule: int = 512,
                 steps_per_epoch: int = 100, descriptor: str = "fcgf",
                 device_maps: Optional[bool] = None, device=None):
        """descriptor='fpfh' swaps the frozen FCGF for FPFH (the fpfh
        variant, GMF_DGR_fpfh core/trainer.py:659-697). device_maps: build
        the kernel maps on the device; None = on unless it is the CPU."""
        self.cfg = config or DGRTrainConfig()
        self.device = resolve_device(device)
        self.descriptor = descriptor
        self.device_maps = (self.device.type != "cpu" if device_maps is None
                            else device_maps)
        self.fcgf = fcgf.to(self.device).eval()
        self.inlier = inlier.to(self.device)
        self.params: List[torch.nn.Parameter] = list(self.inlier.parameters())
        self.voxel_cap_granule = voxel_cap_granule
        self.corr_cap_granule = corr_cap_granule
        self.steps_per_epoch = steps_per_epoch
        cfg = self.cfg
        if cfg.optimizer == "SGD":
            self.optimizer = torch.optim.SGD(
                self.params, lr=cfg.lr, momentum=cfg.momentum, dampening=0,
                weight_decay=cfg.weight_decay)
        else:
            self.optimizer = torch.optim.Adam(
                self.params, lr=cfg.lr, weight_decay=cfg.weight_decay,
                eps=1e-8)
        self.applied_steps = 0
        self.stage_seconds: Optional[Dict[str, float]] = None

    def _stage(self, name: str):
        return timed_stage(self.stage_seconds, name, self.device)

    def learning_rate(self) -> float:
        """optax's staircase exponential decay over applied updates."""
        return self.cfg.lr * self.cfg.exp_gamma ** (
            self.applied_steps // max(self.steps_per_epoch, 1))

    def _tensor(self, x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=self.device)

    def _pyramid_arrays(self, coords, net, granule: int):
        return pyramid_arrays(coords, net.conv1_kernel_size, granule,
                              self.device_maps, self.device)

    # -- the net's input ---------------------------------------------------

    def generate_inlier_input(self, pair: Dict[str, np.ndarray]):
        """Descriptors, 1-NN pairs and correctness labels (ref :644-678;
        fpfh variant :659-697).

        Returns (pred_pairs [N, 2], is_correct [N] f32, F0, F1), the
        descriptors on the device for 'feats'-mode input features."""
        feats = []
        for key_c, key_p in (("coords0", "pcd0"), ("coords1", "pcd1")):
            if self.descriptor == "fpfh":
                from gmf_tpu_torch.ops.fpfh import compute_fpfh

                vs = self.cfg.voxel_size
                feats.append(compute_fpfh(self._tensor(pair[key_p]),
                                          normal_radius=2 * vs,
                                          feature_radius=5 * vs))
                continue
            coords = pair[key_c]
            arrays = self._pyramid_arrays(coords, self.fcgf,
                                          self.voxel_cap_granule)
            with torch.no_grad():
                f = torch.ones(arrays["mask_0"].shape[0], 1,
                               device=self.device)
                feats.append(self.fcgf(f, arrays)[:len(coords)])
        F0, F1 = feats
        nn01, _ = nearest_neighbor(F0, F1, chunk=1024)
        pred_pairs = np.stack([np.arange(len(F0)), nn01.cpu().numpy()], 1)
        hash_seed = max(len(F0), len(F1))
        is_correct = find_correct_correspondence(
            pair["correspondences"], pred_pairs, hash_seed)
        return pred_pairs, is_correct.astype(np.float32), F0, F1

    def _uniq_feats(self, pair, pred_pairs, F0, F1, first_idx, cap):
        """[cap, C] net input on the unique 6-D voxels (each voxel's
        first correspondence; zero pad rows)."""
        if self.cfg.inlier_feature_type == "ones":
            return torch.ones(cap, 1, device=self.device)
        corr_feats = inlier_input_features(
            self.cfg.inlier_feature_type, pair["pcd0"], pair["pcd1"], F0,
            F1, pred_pairs[:, 0], pred_pairs[:, 1], device=self.device)
        feats = torch.zeros(cap, corr_feats.shape[1], device=self.device)
        feats[:len(first_idx)] = corr_feats[
            torch.as_tensor(first_idx, device=self.device)]
        return feats

    def _prep_pair_raw(self, pair: Dict[str, np.ndarray]):
        """Descriptors, matching, labels and the 6-D quantization."""
        with self._stage("descriptors"):
            pred_pairs, is_correct, F0, F1 = self.generate_inlier_input(pair)
        with self._stage("pyramid_6d"):
            corr6d = np.concatenate(
                [pair["coords0"][pred_pairs[:, 0]],
                 pair["coords1"][pred_pairs[:, 1]]], axis=1)
            uniq, first, inverse = sparse_quantize(
                corr6d.astype(np.float64), 1.0, return_index=True,
                return_inverse=True)
        return dict(pair=pair, pred_pairs=pred_pairs, is_correct=is_correct,
                    F0=F0, F1=F1, uniq=uniq, first=first, inverse=inverse)

    def _prep_pair_arrays(self, raw, granule: int):
        """The pair's tensors at the bucket ``granule``: the pyramid and
        input features, and the correspondences padded to a multiple of
        it (a padded row points at voxel cap - 1, masked out)."""
        pair, pred_pairs = raw["pair"], raw["pred_pairs"]
        with self._stage("pyramid_6d"):
            arrays = self._pyramid_arrays(raw["uniq"], self.inlier, granule)
            cap = arrays["mask_0"].shape[0]
            feats = self._uniq_feats(pair, pred_pairs, raw["F0"], raw["F1"],
                                     raw["first"], cap)
        n = len(pred_pairs)
        cap_corr = -(-n // granule) * granule
        inv = np.full(cap_corr, cap - 1, np.int64)
        inv[:n] = raw["inverse"]
        mask = np.zeros(cap_corr, np.float32)
        mask[:n] = 1.0
        corr_ok = np.zeros(cap_corr, np.float32)
        corr_ok[:n] = raw["is_correct"]
        src = np.zeros((cap_corr, 3), np.float32)
        tgt = np.zeros((cap_corr, 3), np.float32)
        src[:n] = pair["pcd0"][pred_pairs[:, 0]]
        tgt[:n] = pair["pcd1"][pred_pairs[:, 1]]
        return dict(
            feats=feats, pyramid=arrays,
            p_img=self._tensor(pair["p_image"])[None],
            q_img=self._tensor(pair["q_image"])[None],
            src=self._tensor(src), tgt=self._tensor(tgt),
            mask=self._tensor(mask), corr_ok=self._tensor(corr_ok),
            T_gt=self._tensor(pair["T_gt"]),
            inv=self._tensor(inv, torch.int64))

    def _prep_pair(self, pair: Dict[str, np.ndarray]):
        return self._prep_pair_arrays(self._prep_pair_raw(pair),
                                      self.corr_cap_granule)

    # -- the loss and the step ----------------------------------------------

    def pair_loss(self, p):
        """(loss, metrics) of one prepared pair, the net in train mode
        (ref :146-177)."""
        cfg = self.cfg
        self.inlier.train()
        logits_vox = self.inlier(p["feats"], p["pyramid"],
                                 p_image=p["p_img"], q_image=p["q_img"])
        logits = logits_vox[p["inv"], 0]  # voxel -> correspondence
        weights = torch.sigmoid(logits) * p["mask"]
        # the training clip keeps weights above the threshold (ref :232-238)
        weights = torch.where(weights > cfg.clip_weight_thresh, weights,
                              torch.zeros_like(weights))
        T_pred = kabsch_quat(p["src"][None], p["tgt"][None],
                             weights[None])[0]
        ws = weights.sum()
        T_gt = p["T_gt"]
        tr = (T_pred[:3, :3] * T_gt[:3, :3]).sum()
        rot_err = torch.arccos(torch.clamp((tr - 1.0) / 2.0, -1 + 1e-7,
                                           1 - 1e-7))
        trans_err = torch.linalg.norm(T_pred[:3, 3] - T_gt[:3, 3])
        individual = rot_err + cfg.trans_weight * trans_err
        valid = (ws > 10).float()  # ref :252-254
        procrustes_loss = cfg.procrustes_loss_weight * individual * valid
        inlier_loss = cfg.inlier_weight * balanced_bce_loss(
            logits, p["corr_ok"], mask=p["mask"])
        loss = procrustes_loss + inlier_loss
        rot_deg = torch.rad2deg(rot_err)
        metrics = {
            "loss": loss, "rot_err_deg": rot_deg, "trans_err": trans_err,
            "ws": ws, "valid": valid, "inlier_loss": inlier_loss,
            "success": ((trans_err < cfg.success_rte_thresh)
                        & (rot_deg < cfg.success_rre_thresh)).float(),
        }
        return loss, metrics

    def train_pair(self, pair: Dict[str, np.ndarray]):
        """One pair's gradients (a list in ``self.params``' order, zero
        where the loss does not reach a parameter) and metrics; the batch
        statistics move on whatever the loss."""
        p = self._prep_pair(pair)
        with self._stage("forward_backward"):
            loss, metrics = self.pair_loss(p)
            grads = torch.autograd.grad(loss, self.params, allow_unused=True)
            grads = [torch.zeros_like(w) if g is None else g
                     for w, g in zip(self.params, grads)]
        return grads, floats(metrics)

    def train_step(self, pairs: Iterable[Dict[str, np.ndarray]]):
        """The gradients of the pairs with a finite loss, summed and
        divided by their count, then one update unless one of them is
        not finite. Returns the mean metrics and ``skipped``."""
        acc, count, agg = None, 0, {}
        for pair in pairs:
            grads, metrics = self.train_pair(pair)
            if not math.isfinite(metrics["loss"]):
                continue  # ref :259-262
            acc = grads if acc is None else [a + g
                                             for a, g in zip(acc, grads)]
            count += 1
            for k, v in metrics.items():
                agg[k] = agg.get(k, 0.0) + v
        if count == 0:
            return {"skipped": 1.0}
        with self._stage("update"):
            acc = [a / count for a in acc]
            finite = bool(torch.isfinite(
                torch.cat([a.reshape(-1) for a in acc])).all())
            if finite:
                for w, g in zip(self.params, acc):
                    w.grad = g
                for group in self.optimizer.param_groups:
                    group["lr"] = self.learning_rate()
                self.optimizer.step()
                self.optimizer.zero_grad(set_to_none=True)
                self.applied_steps += 1
        out = {k: v / count for k, v in agg.items()}
        out["skipped"] = 0.0 if finite else 1.0
        return out

    def train_step_dp(self, pairs, mesh):
        raise NotImplementedError(
            "train_step_dp: data-parallel DGR training over a mesh of cards "
            "waits for ROADMAP queue 1 item 6; train_step trains on one")

    # -- validation ---------------------------------------------------------

    def validate(self, pairs: Iterable[Dict[str, np.ndarray]]):
        """Hit ratio, precision/recall/F1, RTE/RRE and success rate with
        the current net in eval mode, no update (ref _valid_epoch
        :360-503): weights below the clip set to 0, Procrustes, then
        ``se3_refine`` for at most 200 iterations."""
        self.inlier.eval()
        agg: Dict[str, float] = {}
        count = 0
        for pair in pairs:
            raw = self._prep_pair_raw(pair)
            is_correct, pred_pairs = raw["is_correct"], raw["pred_pairs"]
            hit_ratio = float(is_correct.mean()) if len(is_correct) else 0.0
            arrays = self._pyramid_arrays(raw["uniq"], self.inlier,
                                          self.corr_cap_granule)
            feats = self._uniq_feats(pair, pred_pairs, raw["F0"], raw["F1"],
                                     raw["first"], arrays["mask_0"].shape[0])
            with torch.no_grad():
                logits_vox = self.inlier(
                    feats, arrays, p_image=self._tensor(pair["p_image"])[None],
                    q_image=self._tensor(pair["q_image"])[None])
            logits = logits_vox[:, 0].cpu().numpy()[raw["inverse"]]
            weights = 1.0 / (1.0 + np.exp(-logits))
            weights = np.where(weights < self.cfg.clip_weight_thresh, 0.0,
                               weights)
            src = self._tensor(pair["pcd0"][pred_pairs[:, 0]])
            tgt = self._tensor(pair["pcd1"][pred_pairs[:, 1]])
            w = self._tensor(weights)
            T0 = kabsch_quat(src[None], tgt[None], w[None])[0]
            T, _, _ = se3_refine(src, tgt, w, T0, max_iter=200)
            T = T.cpu().numpy()
            T_gt = pair["T_gt"]
            tr = float(np.trace(T[:3, :3].T @ T_gt[:3, :3]))
            rre = float(np.degrees(np.arccos(np.clip((tr - 1) / 2, -1, 1))))
            rte = float(np.linalg.norm(T[:3, 3] - T_gt[:3, 3]))

            pred = logits > 0
            tp = float((pred & (is_correct > 0)).sum())
            precision = tp / max(pred.sum(), 1)
            recall = tp / max((is_correct > 0).sum(), 1)
            f1 = 2 * precision * recall / max(precision + recall, 1e-9)
            stats = {
                "hit_ratio": hit_ratio, "precision": precision,
                "recall": recall, "f1": f1, "rte": rte, "rre": rre,
                "success": float((rte < self.cfg.success_rte_thresh)
                                 and (rre < self.cfg.success_rre_thresh)),
            }
            count += 1
            for k, v in stats.items():
                agg[k] = agg.get(k, 0.0) + v
        return {k: v / max(count, 1) for k, v in agg.items()}

    def inlier_variables(self) -> Dict[str, torch.Tensor]:
        """The inlier net's ``state_dict`` (parameters and statistics)."""
        return self.inlier.state_dict()
