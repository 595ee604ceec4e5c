"""PointDSC+GMF training command line.

Counterpart of ``gmf_tpu/train/train_pointdsc.py`` (reference:
GMF_PointDSC/train_3DMatch.py): build the loaders from the config, write
the resolved config and the training sources into the snapshot directory,
and run the epoch loop with recall-stamped checkpoints.

    python -m gmf_tpu_torch.train.train_pointdsc --dataset synthetic
    python -m gmf_tpu_torch.train.train_pointdsc --dataset synthetic \\
        --tiny --cpu --max-epoch 1 --steps-per-epoch 2 --save-dir /tmp/s

It runs on the card unless ``--cpu`` is given. As the reference's
(gmf_tpu/train/train_pointdsc.py:170-177), the model trains with the
dense attention (``fused_attention=False``) unless ``--fused`` asks for
the attention kernels; the checkpoints record which. ``--prefetch`` is
accepted for command compatibility and changes nothing: batches are
built inline. The 3DMatch and KITTI loaders come with the port's
evaluation stack; until then those datasets stop with an error.
"""

from __future__ import annotations

import argparse
import os
import time

SOURCES = [
    "gmf_tpu_torch.models.pointdsc", "gmf_tpu_torch.nn.fusion",
    "gmf_tpu_torch.nn.resnet", "gmf_tpu_torch.nn.norm",
    "gmf_tpu_torch.ops.fused_attention", "gmf_tpu_torch.train.trainer",
    "gmf_tpu_torch.train.losses", "gmf_tpu_torch.train.train_pointdsc",
    "gmf_tpu_torch.configs.presets",
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
                    help="accepted for command compatibility; batches are "
                         "built inline")
    ap.add_argument("--tiny", action="store_true", help="tiny smoke config")
    ap.add_argument("--fused", action="store_true",
                    help="train through the attention kernels (fused "
                         "attention) instead of the dense attention")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.dataset != "synthetic":
        raise SystemExit(
            f"--dataset {args.dataset}: the port's {args.dataset} loader "
            "comes with its evaluation stack and is not ported yet; use "
            "--dataset synthetic")

    from gmf_tpu_torch.configs import pointdsc_3dmatch
    from gmf_tpu_torch.data.synthetic import SyntheticCorrespondenceLoader
    from gmf_tpu_torch.models import PointDSC
    from gmf_tpu_torch.train.trainer import TrainConfig, Trainer
    from gmf_tpu_torch.utils.checkpoint import snapshot_sources

    cfg = pointdsc_3dmatch()
    if args.max_epoch is not None:
        cfg.max_epoch = args.max_epoch
    if args.batch_size is not None:
        cfg.data.batch_size = args.batch_size
    if args.lr is not None:
        cfg.lr = args.lr

    save_dir = args.save_dir or os.path.join(
        "outputs", "snapshot",
        f"PointDSC_{args.dataset}_{time.strftime('%m%d%H%M')}")
    os.makedirs(save_dir, exist_ok=True)
    cfg.to_json(os.path.join(save_dir, "config.json"))
    snapshot_sources(save_dir, SOURCES)
    print(f"snapshot dir: {save_dir}", flush=True)

    spe = args.steps_per_epoch or 4
    bs = args.batch_size or 4
    num_corr = 256 if args.tiny else args.num_node
    hw = (24, 32) if args.tiny else (120, 160)
    train_loader = SyntheticCorrespondenceLoader(
        batch_size=bs, num_corr=num_corr, steps_per_epoch=spe, image_hw=hw)
    val_loader = SyntheticCorrespondenceLoader(
        batch_size=bs, num_corr=num_corr, steps_per_epoch=max(spe // 4, 1),
        image_hw=hw, seed=1)

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
    trainer = Trainer(model, tcfg, train_loader, val_loader,
                      steps_per_epoch=len(train_loader))
    if args.pretrain:
        trainer.load(args.pretrain)
        print(f"loaded pretrain from {args.pretrain}", flush=True)

    history = trainer.train(snapshot=True)
    final = [h for h in history if h[0] == "eval"][-1][2]
    print(f"final eval: recall={final['reg_recall']:.2f}% "
          f"class_loss={final['class_loss']:.4f}", flush=True)
    return history


if __name__ == "__main__":
    main()
