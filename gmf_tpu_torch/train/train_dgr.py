"""DGR+GMF training command line.

Counterpart of ``gmf_tpu/train/train_dgr.py`` (reference:
GMF_DGR_fcgf/train_3DMatch.py, train_Kitti.py and the fpfh variant's
train.py): pair loaders, the frozen FCGF and the trainable inlier net,
``WeightedProcrustesTrainer`` epochs with a checkpoint per epoch and the
best one.

    python -m gmf_tpu_torch.train.train_dgr --dataset 3dmatch --root DATA \\
        --split-file splits/train_3dmatch.txt --fcgf-checkpoint FCGF
    python -m gmf_tpu_torch.train.train_dgr --dataset kitti --root KITTI
    python -m gmf_tpu_torch.train.train_dgr --dataset synthetic --tiny \\
        --cpu --max-epoch 1 --steps-per-epoch 1 --save-dir /tmp/dgr

It runs on the card unless ``--cpu`` is given. ``--fcgf-checkpoint`` and
``--resume`` read the port's checkpoints (``utils/checkpoint.py``); the
epoch checkpoints hold the inlier net, with config ``{"dgr": ...,
"descriptor": ...}``, and load through ``utils/model_io.py::load_dgr``
beside the FCGF checkpoint. ``--mesh`` (data parallelism over cards)
waits for ROADMAP queue 1 item 6 and is refused.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

SOURCES = [
    "gmf_tpu_torch.models.dgr", "gmf_tpu_torch.sparse.resunet",
    "gmf_tpu_torch.train.dgr_trainer", "gmf_tpu_torch.train.train_dgr",
    "gmf_tpu_torch.configs.presets",
]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dataset", default="3dmatch",
                    choices=["3dmatch", "kitti", "synthetic"])
    ap.add_argument("--root", default="")
    ap.add_argument("--split-file", default=None)
    ap.add_argument("--descriptor", default="fcgf",
                    choices=["fcgf", "fpfh"])
    ap.add_argument("--fcgf-checkpoint", default=None,
                    help="pretrained frozen FCGF weights (a port "
                         "checkpoint directory)")
    ap.add_argument("--max-epoch", type=int, default=None)
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--steps-per-epoch", type=int, default=None)
    ap.add_argument("--save-dir", default=None)
    ap.add_argument("--resume", default=None,
                    help="inlier net checkpoint to continue from")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU through the plain versions")
    ap.add_argument("--mesh", type=int, default=0, metavar="N",
                    help="data-parallel training over N cards (not ported "
                         "yet: refused)")
    ap.add_argument("--prefetch", type=int, default=0,
                    help="prefetch pair batches N-deep on a thread")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--n-points", type=int, default=None,
                    help="synthetic pair size (default: 300 tiny / 2000)")
    ap.add_argument("--outlier-bias", type=float, default=0.0,
                    help="displace cloud 1's partner-less points by this "
                         "constant offset (data/dgr_loader.make_dgr_pair)")
    ap.add_argument("--overlap", type=float, default=0.7,
                    help="synthetic pair overlap fraction")
    ap.add_argument("--cloud", choices=["uniform", "surface"],
                    default="uniform",
                    help="synthetic pair geometry: 'surface' (heightfield) "
                         "gives FPFH meaningful normals")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.mesh:
        from gmf_tpu_torch.eval.cli import refuse

        refuse("--mesh")

    import torch

    from gmf_tpu_torch.configs.presets import dgr_3dmatch, dgr_kitti
    from gmf_tpu_torch.data.dgr_loader import make_dgr_pair
    from gmf_tpu_torch.data.prefetch import prefetch_iter
    from gmf_tpu_torch.eval.test_dgr import tiny_nets
    from gmf_tpu_torch.sparse.resunet import FCGFNet, GMFInlierNet
    from gmf_tpu_torch.train.dgr_trainer import WeightedProcrustesTrainer
    from gmf_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                save_checkpoint,
                                                snapshot_sources)
    from gmf_tpu_torch.utils.device import resolve_device

    device = resolve_device("cpu" if args.cpu else None)
    cfg = dgr_kitti() if args.dataset == "kitti" else dgr_3dmatch()
    if args.max_epoch is not None:
        cfg.max_epoch = args.max_epoch
    if args.batch_size is not None:
        cfg.batch_size = args.batch_size

    save_dir = args.save_dir or os.path.join(
        "outputs", "snapshot",
        f"DGR_{args.dataset}_{time.strftime('%m%d%H%M')}")
    os.makedirs(save_dir, exist_ok=True)
    # source provenance next to the checkpoints (ref train_3DMatch.py:30-34)
    snapshot_sources(save_dir, SOURCES)

    torch.manual_seed(0)
    if args.tiny:
        fcgf, inlier = tiny_nets()
        granule, image_hw = 256, (16, 16)
    else:
        fcgf = FCGFNet(conv1_kernel_size=cfg.feat_conv1_kernel_size)
        inlier = GMFInlierNet(conv1_kernel_size=cfg.inlier_conv1_kernel_size)
        granule, image_hw = 2048, (120, 160)
    if args.fcgf_checkpoint:
        fcgf.load_state_dict(load_checkpoint(args.fcgf_checkpoint)[0],
                             strict=True)
        print(f"loaded frozen FCGF from {args.fcgf_checkpoint}")
    if args.resume:
        inlier.load_state_dict(load_checkpoint(args.resume)[0], strict=True)
        print(f"resumed inlier net from {args.resume}")

    rng = np.random.RandomState(0)
    n_points = args.n_points or (300 if args.tiny else 2000)

    def synthetic_pair():
        return make_dgr_pair(rng, n_points=n_points,
                             voxel_size=cfg.voxel_size, image_hw=image_hw,
                             overlap=args.overlap,
                             outlier_bias=args.outlier_bias,
                             surface=args.cloud == "surface")

    # gmf_tpu initialises its nets on a prototype pair and a random 6-D
    # cloud; drawing both keeps the synthetic pairs its pairs
    synthetic_pair()
    rng.randint(0, 8, (64, 6))

    trainer = WeightedProcrustesTrainer(
        fcgf, inlier, cfg, voxel_cap_granule=granule,
        corr_cap_granule=granule, descriptor=args.descriptor, device=device)

    if args.dataset == "synthetic":
        spe = args.steps_per_epoch or 2

        def epoch_pairs():
            for _ in range(spe):
                yield [synthetic_pair() for _ in range(cfg.batch_size)]
    else:
        from gmf_tpu_torch.data.dgr_loader import ThreeDMatchPairDataset
        from gmf_tpu_torch.data.kitti_dgr_loader import KITTINMPairDataset

        if args.dataset == "3dmatch":
            ds = ThreeDMatchPairDataset(
                root=args.root, split_file=args.split_file,
                voxel_size=cfg.voxel_size, image_hw=image_hw)
        else:
            ds = KITTINMPairDataset(args.root, voxel_size=cfg.voxel_size,
                                    image_hw=image_hw, device=device)
        if not len(ds):
            raise SystemExit(f"--dataset {args.dataset}: no pairs under "
                             f"--root {args.root!r}")
        spe = args.steps_per_epoch or max(len(ds) // cfg.batch_size, 1)

        def epoch_pairs():
            order = np.random.permutation(len(ds))
            for step in range(spe):
                idx = order[step * cfg.batch_size:(step + 1) * cfg.batch_size]
                yield [ds[int(i)] for i in idx]

    best = -1.0
    for epoch in range(cfg.max_epoch):
        sums, count = {}, 0
        for pairs in prefetch_iter(epoch_pairs(), args.prefetch):
            m = trainer.train_step(pairs)
            count += 1
            for k, v in m.items():
                sums[k] = sums.get(k, 0.0) + v
        avg = {k: v / max(count, 1) for k, v in sums.items()}
        print(f"epoch {epoch + 1}: " + " ".join(
            f"{k}={v:.4f}" for k, v in sorted(avg.items())), flush=True)
        save_checkpoint(
            os.path.join(save_dir, f"checkpoint_epoch_{epoch + 1}"),
            trainer.inlier_variables(),
            config={"dgr": cfg.__dict__, "descriptor": args.descriptor})
        succ = avg.get("success", 0.0)
        if succ > best:
            best = succ
            save_checkpoint(os.path.join(save_dir, "best_val_checkpoint"),
                            trainer.inlier_variables(),
                            config={"dgr": cfg.__dict__})
    print(f"done; snapshots in {save_dir}", flush=True)
    return save_dir


if __name__ == "__main__":
    main()
