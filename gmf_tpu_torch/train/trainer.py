"""PointDSC+GMF trainer, on one card or data-parallel over a mesh.

Counterpart of ``gmf_tpu/train/trainer.py`` (reference:
GMF_PointDSC/libs/trainer.py):

- loss = w_c * classification + w_sm * spectral matching + w_t *
  transformation, w_t = ``weight_transformation`` once epoch >
  ``transformation_loss_start_epoch``, else 0. The transformation term is
  always computed, so a non-finite gradient in it trips the guard as
  0 * NaN does in the reference.
- Adam(lr, weight_decay) with the decay added to the gradient before Adam
  (optax's ``add_decayed_weights`` then ``adam``), eps 1e-8.
- The learning rate is ``lr * gamma ** (applied_steps // steps_per_epoch)``:
  optax counts only applied steps, since the guard below also holds back
  the optimizer's state.
- NaN guard: when any gradient is not finite, neither the parameters nor
  Adam's state change and ``skipped_step`` is 1. The batch-norm statistics
  the forward updated are kept either way, as in the reference.
- ``Trainer``: eval at epoch 0, then per epoch training and eval, a
  best-recall snapshot and a recall-stamped one.

Every parameter gets a gradient, zero where the loss does not reach it,
so Adam and the weight decay move every parameter as optax moves them.

Over a mesh (``Trainer(mesh=...)``, ``parallel/mesh.py``) every rank
holds the same parameters (rank 0's, broadcast once) and takes the same
global batch; a step is its slice of the batch, the forward inside
``parallel.sharded`` (batch norms on the global statistics, losses
normalised by the global counts), then the gradients summed over the
'data' axis in one flat buffer: the global gradient, since each rank's
loss is its part of the global one. A non-finite gradient on any rank
makes the sum non-finite everywhere, so every rank skips together, and
every rank applies the same Adam update. gmf_tpu's sharded step equals
its single-device step (tests/test_parallel.py); so does this one. Rank
0 alone prints and writes checkpoints.
"""

from __future__ import annotations

import copy
import dataclasses
import os
from typing import Dict, Optional

import numpy as np
import torch

from gmf_tpu_torch.data.prefetch import prefetch_iter
from gmf_tpu_torch.parallel.mesh import replicate, shard_batch, sharded
from gmf_tpu_torch.train.losses import (classification_loss,
                                        spectral_matching_loss,
                                        transformation_loss)
from gmf_tpu_torch.utils.checkpoint import (CHECKPOINT_FORMATS,
                                            save_checkpoint,
                                            save_gmf_checkpoint)
from gmf_tpu_torch.utils.logging_utils import MetricsLogger
from gmf_tpu_torch.utils.model_io import (GMF_POINTDSC_FIELDS, load_state,
                                          state_dict_to_tree)


@dataclasses.dataclass
class TrainConfig:
    """The reference config's optimizer and loss groups."""

    lr: float = 1e-4
    weight_decay: float = 1e-6
    scheduler_gamma: float = 0.99
    max_epoch: int = 100
    batch_size: int = 16
    weight_classification: float = 1.0
    weight_spectralmatching: float = 1.0
    weight_transformation: float = 0.0
    transformation_loss_start_epoch: int = 0
    re_thresh: float = 15.0
    te_thresh: float = 30.0  # cm
    save_dir: str = "snapshot"


def make_optimizer(model, cfg: TrainConfig) -> torch.optim.Adam:
    return torch.optim.Adam(model.parameters(), lr=cfg.lr,
                            weight_decay=cfg.weight_decay, eps=1e-8)


def learning_rate(cfg: TrainConfig, applied_steps: int,
                  steps_per_epoch: int) -> float:
    """optax's staircase exponential decay over applied steps."""
    return cfg.lr * cfg.scheduler_gamma ** (
        applied_steps // max(steps_per_epoch, 1))


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A loader's NumPy batch as f32 tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v, np.float32)).to(device)
            for k, v in batch.items()}


def _forward_losses(model, batch, cfg: TrainConfig, w_t):
    """The model's train branch and its losses: (loss, metrics)."""
    mask = batch.get("corr_mask")
    out = model(batch["corr_pos"], batch["src_keypts"], batch["tgt_keypts"],
                batch["p_image"], batch["q_image"], testing=False,
                corr_mask=mask)
    cls = classification_loss(out["final_labels"], batch["labels"],
                              mask=mask)
    sm = spectral_matching_loss(out["M"], batch["labels"], mask=mask)
    tr = transformation_loss(
        out["final_trans"], batch["gt_trans"], batch["src_keypts"],
        batch["tgt_keypts"], out["final_labels"], re_thresh=cfg.re_thresh,
        te_thresh=cfg.te_thresh, mask=mask)
    loss = (cfg.weight_classification * cls["loss"]
            + cfg.weight_spectralmatching * sm + w_t * tr["loss"])
    metrics = {
        "loss": loss,
        "class_loss": cls["loss"],
        "sm_loss": sm,
        "trans_loss": tr["loss"],
        "reg_recall": tr["recall_pct"],
        "re": tr["re_deg"],
        "te": tr["te_cm"],
        "precision": cls["precision"],
        "recall": cls["recall"],
        "f1": cls["f1"],
    }
    return loss, metrics


def floats(metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Metric tensors (scalars) as Python floats, with one device-to-host
    copy."""
    values = torch.stack([v.detach().float() for v in metrics.values()])
    return dict(zip(metrics, values.tolist()))


def train_step(model, optimizer, cfg: TrainConfig, batch, epoch: int,
               lr: float, mesh=None) -> Dict[str, float]:
    """One step on a batch of tensors: forward in train mode, backward,
    and the Adam update at ``lr`` unless a gradient is not finite.
    Returns the metrics, ``skipped_step`` among them. The gradients stay
    in the parameters' ``.grad``. With a ``mesh``, ``batch`` is this
    rank's slice of the global batch (module docstring)."""
    model.train()
    device = next(model.parameters()).device
    w_t = torch.tensor(cfg.weight_transformation
                       if epoch > cfg.transformation_loss_start_epoch
                       else 0.0, device=device)
    with sharded(mesh):
        loss, metrics = _forward_losses(model, batch, cfg, w_t)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
    params = [p for group in optimizer.param_groups for p in group["params"]]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    # one flat buffer: one check over all gradients (a few launches, not
    # five per tensor) and, over a mesh, one all-reduce
    flat = torch.cat([p.grad.reshape(-1) for p in params])
    if mesh is not None and mesh.n_data > 1:
        import torch.distributed as dist

        dist.all_reduce(flat, group=mesh.group("data"))
        at = 0
        for p in params:
            p.grad.copy_(flat[at:at + p.numel()].view_as(p))
            at += p.numel()
    finite = torch.isfinite(flat).all()
    applied = bool(finite)
    if applied:
        for group in optimizer.param_groups:
            group["lr"] = lr
        optimizer.step()
    out = floats(metrics)
    out["skipped_step"] = 0.0 if applied else 1.0
    return out


@torch.no_grad()
def eval_step(model, cfg: TrainConfig, batch, mesh=None) -> Dict[str, float]:
    """Validation step: the train branch with running batch-norm
    statistics, the same losses, no update (over a mesh, on this rank's
    slice, the metrics the global batch's)."""
    model.eval()
    with sharded(mesh):
        _, metrics = _forward_losses(model, batch, cfg, 0.0)
    del metrics["loss"]
    return floats(metrics)


class Trainer:
    """Epoch loop with evaluation and snapshots, on the model's device.

    ``train_loader`` and ``val_loader`` yield dicts of NumPy arrays (see
    ``data/synthetic.py``); ``steps_per_epoch`` defaults to the train
    loader's, which the learning-rate schedule counts in. ``prefetch > 0``
    builds that many batches ahead on a thread (``data/prefetch.py``), so
    that the host's batch construction overlaps the card's steps.

    ``mesh``: data parallelism over its 'data' axis (module docstring);
    every rank builds the trainer with the same model and loaders. As in
    gmf_tpu, a model whose ``compat_cache_shards`` is 1 takes the mesh's
    n_data there (a shallow copy sharing the parameters), so that the
    "auto" cache gate sizes one rank's share of the batch.
    """

    def __init__(self, model, cfg: TrainConfig, train_loader, val_loader,
                 steps_per_epoch: Optional[int] = None, prefetch: int = 0,
                 mesh=None, tboard_dir: Optional[str] = None):
        self.mesh = mesh
        if mesh is not None and mesh.n_data > 1 and getattr(
                model, "compat_cache_shards", 0) == 1:
            model = copy.copy(model)
            model.compat_cache_shards = mesh.n_data
        if mesh is not None:
            replicate(model, mesh)
        self.model = model
        self.cfg = cfg
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.steps_per_epoch = (
            steps_per_epoch if steps_per_epoch is not None
            else getattr(train_loader, "steps_per_epoch", 100))
        self.prefetch = prefetch
        self.optimizer = make_optimizer(model, cfg)
        self.applied_steps = 0
        self.history = []
        # gmf_tpu's metrics log (utils/logging_utils.py): "Val" and
        # "Train" rows by epoch, in tboard_dir; nothing without one
        self.logger = MetricsLogger(tboard_dir if self.is_chief else None)

    @property
    def device(self):
        return next(self.model.parameters()).device

    @property
    def is_chief(self) -> bool:
        """Whether this process prints and writes (rank 0 of the mesh)."""
        return self.mesh is None or self.mesh.rank == self.mesh.ranks[0]

    def _local(self, batch) -> Dict[str, torch.Tensor]:
        """A NumPy batch as f32 tensors on the device: over a mesh, this
        rank's slice of it."""
        if self.mesh is None:
            return to_device(batch, self.device)
        return shard_batch({k: np.asarray(v, np.float32)
                            for k, v in batch.items()}, self.mesh)

    def train_step(self, batch, epoch: int) -> Dict[str, float]:
        """One step on a NumPy batch; counts it when it was applied."""
        metrics = train_step(
            self.model, self.optimizer, self.cfg, self._local(batch), epoch,
            learning_rate(self.cfg, self.applied_steps,
                          self.steps_per_epoch), mesh=self.mesh)
        self.applied_steps += metrics["skipped_step"] == 0.0
        return metrics

    def eval_step(self, batch) -> Dict[str, float]:
        return eval_step(self.model, self.cfg, self._local(batch),
                         mesh=self.mesh)

    @staticmethod
    def _mean(rows):
        rows = list(rows)
        return {k: sum(r[k] for r in rows) / max(len(rows), 1)
                for k in (rows[0] if rows else {})}

    def _batches(self, loader):
        return prefetch_iter(loader, self.prefetch)

    def train_epoch(self, epoch: int) -> Dict[str, float]:
        return self._mean(self.train_step(b, epoch)
                          for b in self._batches(self.train_loader))

    def evaluate(self) -> Dict[str, float]:
        return self._mean(self.eval_step(b)
                          for b in self._batches(self.val_loader))

    def train(self, snapshot: bool = True, checkpoint_format: str = "pt"):
        """Eval at epoch 0, then per epoch training, eval and (with
        ``snapshot``) checkpoints in ``checkpoint_format`` (``save``)."""
        best_recall = -1.0
        res = self.evaluate()
        self.history.append(("eval", 0, res))
        self.logger.log(res, 0, "Val")
        for epoch in range(self.cfg.max_epoch):
            train_res = self.train_epoch(epoch + 1)
            self.history.append(("train", epoch + 1, train_res))
            self.logger.log(train_res, epoch + 1, "Train")
            res = self.evaluate()
            self.history.append(("eval", epoch + 1, res))
            self.logger.log(res, epoch + 1, "Val")
            if self.is_chief:
                print(f"epoch {epoch + 1}: " + " ".join(
                    f"{k}={v:.4f}" for k, v in res.items()), flush=True)
            if snapshot and self.is_chief:
                if res["reg_recall"] > best_recall:
                    best_recall = res["reg_recall"]
                    self.save(os.path.join(self.cfg.save_dir, "model_best"),
                              checkpoint_format)
                self.save(os.path.join(
                    self.cfg.save_dir,
                    f"model_{epoch + 1}_recall_{res['reg_recall']:.2f}"),
                    checkpoint_format)
        return self.history

    def save(self, path: str, checkpoint_format: str = "pt"):
        """Snapshot the model's state and the config, the model's
        settings included, so evaluation can rebuild the network from the
        checkpoint alone. "pt": the port's ``state.pt`` and the port's
        settings; "gmf": what ``gmf_tpu``'s ``Trainer.save`` writes, its
        ``{params, batch_stats}`` tree in ``state.msgpack`` and, under
        "model", the ``PointDSC`` fields it records, from which its
        ``load_pointdsc`` builds a model of the same settings."""
        config = dataclasses.asdict(self.cfg)
        if checkpoint_format == "pt":
            config["model"] = dict(self.model.config)
            save_checkpoint(path, self.model.state_dict(), config=config)
        elif checkpoint_format == "gmf":
            model = {**self.model.config,
                     "compat_cache_shards": self.model.compat_cache_shards}
            config["model"] = {f: model[f] for f in GMF_POINTDSC_FIELDS}
            save_gmf_checkpoint(path, state_dict_to_tree(
                self.model.state_dict(), "pointdsc",
                self.model.config["num_layers"]), config=config)
        else:
            raise ValueError(f"checkpoint_format={checkpoint_format!r}: "
                             f"one of {CHECKPOINT_FORMATS}")

    def load(self, path: str):
        """The model's weights from a checkpoint directory, the port's or
        ``gmf_tpu``'s (its ``params`` and ``batch_stats``, as its own
        ``Trainer.load`` reads them)."""
        state, _ = load_state(path, "pointdsc",
                              self.model.config["num_layers"])
        self.model.load_state_dict(state, strict=True)
