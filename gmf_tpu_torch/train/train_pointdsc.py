"""PointDSC+GMF training command line.

Counterpart of ``gmf_tpu/train/train_pointdsc.py`` (reference:
GMF_PointDSC/train_3DMatch.py, train_KITTI.py): build the loaders from the
config, write the resolved config and the training sources into the
snapshot directory, and run the epoch loop with recall-stamped
checkpoints.

    python -m gmf_tpu_torch.train.train_pointdsc --dataset 3DMatch \\
        --root /data/3DImageMatch --overlap-path /data/overlap
    python -m gmf_tpu_torch.train.train_pointdsc --dataset Kitti \\
        --root /data/kitti
    python -m gmf_tpu_torch.train.train_pointdsc --dataset synthetic \\
        --tiny --cpu --max-epoch 1 --steps-per-epoch 2 --save-dir /tmp/s

It runs on the card unless ``--cpu`` is given. As the reference's
(gmf_tpu/train/train_pointdsc.py:170-177), the model trains with the
dense attention (``fused_attention=False``) unless ``--fused`` asks for
the attention kernels; the checkpoints record which. ``--prefetch N``
builds batches N ahead on a thread (``data/prefetch.py``).
``--checkpoint-format gmf`` writes the snapshots as ``gmf_tpu``'s trainer
writes them (``Trainer.save``), for ``gmf_tpu`` to load. Started in a
world of ranks (``torchrun``, joined by ``parallel/launch.py::
init_world``), it trains data-parallel over all of them, as gmf_tpu's
trainer takes every device by default: each rank draws its batches from
its own strided share of the seeded permutation (``process_shard``) and
trains on its slice of each, so a global batch holds disjoint pairs.
"""

from __future__ import annotations

import argparse
import os
import time

from gmf_tpu_torch.utils.checkpoint import CHECKPOINT_FORMATS


class BatchedLoader:
    """An indexable dataset as a shuffled, min-clip-collated batch
    iterator (the reference's DataLoader and collate_fn,
    datasets/dataloader.py:55-62), with gmf_tpu's draws: a permutation
    from ``RandomState(seed + epoch)``, this process's strided share of it
    (``parallel.process_shard``; the whole permutation outside a world)
    and the collate's subsampling from the same state."""

    def __init__(self, dataset, batch_size: int, steps_per_epoch: int,
                 seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.steps_per_epoch = steps_per_epoch
        self.seed = seed
        self._epoch = 0

    def __iter__(self):
        import numpy as np

        from gmf_tpu_torch.data.collate import min_clip_collate
        from gmf_tpu_torch.parallel.mesh import process_shard

        rng = np.random.RandomState(self.seed + self._epoch)
        self._epoch += 1
        order = process_shard(rng.permutation(len(self.dataset)))
        for step in range(self.steps_per_epoch):
            idx = [order[(step * self.batch_size + b) % len(order)]
                   for b in range(self.batch_size)]
            samples = [{k: v for k, v in self.dataset[i].items()
                        if k != "scene"} for i in idx]
            yield min_clip_collate(samples, rng)

    def __len__(self):
        return self.steps_per_epoch


SOURCES = [
    "gmf_tpu_torch.models.pointdsc", "gmf_tpu_torch.nn.fusion",
    "gmf_tpu_torch.nn.resnet", "gmf_tpu_torch.nn.norm",
    "gmf_tpu_torch.ops.fused_attention", "gmf_tpu_torch.train.trainer",
    "gmf_tpu_torch.train.losses", "gmf_tpu_torch.train.train_pointdsc",
    "gmf_tpu_torch.configs.presets", "gmf_tpu_torch.data.threedmatch",
    "gmf_tpu_torch.data.kitti",
]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dataset", default="3DMatch",
                    choices=["3DMatch", "Kitti", "synthetic"])
    ap.add_argument("--root", default="")
    ap.add_argument("--overlap-path", default="")
    ap.add_argument("--descriptor", default="fcgf")
    ap.add_argument("--max-epoch", type=int, default=None)
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--num-node", type=int, default=1000)
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--save-dir", default=None)
    ap.add_argument("--pretrain", default=None)
    ap.add_argument("--steps-per-epoch", type=int, default=None)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU through the plain versions")
    ap.add_argument("--prefetch", type=int, default=0,
                    help="prefetch batches N-deep on a thread (host batch "
                         "construction overlaps the card's steps)")
    ap.add_argument("--tiny", action="store_true", help="tiny smoke config")
    ap.add_argument("--fused", action="store_true",
                    help="train through the attention kernels (fused "
                         "attention) instead of the dense attention")
    ap.add_argument("--checkpoint-format", choices=CHECKPOINT_FORMATS,
                    default="pt",
                    help="pt: the port's state.pt; gmf: gmf_tpu's "
                         "state.msgpack, as its trainer writes it")
    return ap.parse_args(argv)


def make_loaders(args, cfg):
    """(train loader, val loader) of ``args.dataset``."""
    if args.dataset == "synthetic":
        from gmf_tpu_torch.data.synthetic import SyntheticCorrespondenceLoader

        spe = args.steps_per_epoch or 4
        bs = args.batch_size or 4
        num_corr = 256 if args.tiny else args.num_node
        hw = (24, 32) if args.tiny else (120, 160)
        return (SyntheticCorrespondenceLoader(
                    batch_size=bs, num_corr=num_corr, steps_per_epoch=spe,
                    image_hw=hw),
                SyntheticCorrespondenceLoader(
                    batch_size=bs, num_corr=num_corr,
                    steps_per_epoch=max(spe // 4, 1), image_hw=hw, seed=1))
    bs = cfg.data.batch_size
    if args.dataset == "3DMatch":
        from gmf_tpu_torch.data.threedmatch import ThreeDMatchTrainVal

        common = dict(root=args.root, overlap_path=args.overlap_path,
                      descriptor=args.descriptor, num_node=args.num_node,
                      use_mutual=cfg.data.use_mutual)
        train_ds = ThreeDMatchTrainVal(split="train", **common)
        val_ds = ThreeDMatchTrainVal(split="val", augment_axis=0,
                                     augment_rotation=0.0,
                                     augment_translation=0.0, **common)
        val_steps = min(cfg.val_max_iter, max(len(val_ds) // bs, 1))
    else:  # Kitti
        from gmf_tpu_torch.data.kitti import KITTIDataset

        common = dict(root=args.root, descriptor=args.descriptor,
                      num_node=args.num_node,
                      inlier_threshold=cfg.model.inlier_threshold)
        train_ds = KITTIDataset(split="train", **common)
        val_ds = KITTIDataset(split="val", **common)
        val_steps = max(len(val_ds) // bs, 1)
    for split, ds in (("train", train_ds), ("val", val_ds)):
        if not len(ds):
            raise SystemExit(
                f"--dataset {args.dataset}: no {split} pairs under --root "
                f"{args.root!r} (--overlap-path {args.overlap_path!r})")
    spe = args.steps_per_epoch or min(cfg.training_max_iter,
                                      len(train_ds) // bs)
    return (BatchedLoader(train_ds, bs, spe),
            BatchedLoader(val_ds, bs, val_steps))


def main(argv=None):
    args = parse_args(argv)

    from gmf_tpu_torch.configs import pointdsc_3dmatch, pointdsc_kitti
    from gmf_tpu_torch.models import PointDSC
    from gmf_tpu_torch.train.trainer import TrainConfig, Trainer
    from gmf_tpu_torch.utils.checkpoint import snapshot_sources

    cfg = pointdsc_kitti() if args.dataset == "Kitti" else pointdsc_3dmatch()
    if args.max_epoch is not None:
        cfg.max_epoch = args.max_epoch
    if args.batch_size is not None:
        cfg.data.batch_size = args.batch_size
    if args.lr is not None:
        cfg.lr = args.lr

    train_loader, val_loader = make_loaders(args, cfg)
    save_dir = args.save_dir or os.path.join(
        "outputs", "snapshot",
        f"PointDSC_{args.dataset}_{time.strftime('%m%d%H%M')}")
    os.makedirs(save_dir, exist_ok=True)
    cfg.to_json(os.path.join(save_dir, "config.json"))
    snapshot_sources(save_dir, SOURCES)
    print(f"snapshot dir: {save_dir}", flush=True)

    device = "cpu" if args.cpu else None
    m = cfg.model
    if args.tiny:
        model = PointDSC(num_layers=2, num_channels=32, k=10,
                         inlier_threshold=m.inlier_threshold,
                         sigma_d=m.sigma_d, fused_attention=args.fused,
                         device=device)
    else:
        model = PointDSC(
            in_dim=m.in_dim, num_layers=m.num_layers,
            num_channels=m.num_channels, num_iterations=m.num_iterations,
            ratio=m.ratio, inlier_threshold=m.inlier_threshold,
            sigma_d=m.sigma_d, k=m.k, nms_radius=m.nms_radius,
            fused_attention=args.fused, device=device)

    tcfg = TrainConfig(
        lr=cfg.lr, weight_decay=cfg.weight_decay,
        scheduler_gamma=cfg.scheduler_gamma, max_epoch=cfg.max_epoch,
        batch_size=cfg.data.batch_size,
        weight_classification=cfg.weight_classification,
        weight_spectralmatching=cfg.weight_spectralmatching,
        weight_transformation=cfg.weight_transformation,
        transformation_loss_start_epoch=cfg.transformation_loss_start_epoch,
        re_thresh=cfg.re_thre, te_thresh=cfg.te_thre, save_dir=save_dir)
    from gmf_tpu_torch.parallel.mesh import make_mesh, world_initialized

    mesh = make_mesh(device=model.device) if world_initialized() else None
    trainer = Trainer(model, tcfg, train_loader, val_loader,
                      steps_per_epoch=len(train_loader),
                      prefetch=args.prefetch, mesh=mesh)
    if args.pretrain:
        trainer.load(args.pretrain)
        print(f"loaded pretrain from {args.pretrain}", flush=True)

    history = trainer.train(snapshot=True,
                            checkpoint_format=args.checkpoint_format)
    final = [h for h in history if h[0] == "eval"][-1][2]
    print(f"final eval: recall={final['reg_recall']:.2f}% "
          f"class_loss={final['class_loss']:.4f}", flush=True)
    return history


if __name__ == "__main__":
    main()
