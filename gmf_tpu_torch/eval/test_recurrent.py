"""Checkpoint sweep: 3DMatch recall of every snapshot in a directory.

    python -m gmf_tpu_torch.eval.test_recurrent --root /path/3DImageMatch \\
        --snapshot-dir snapshot/PointDSC_3DMatch_xxx [--cpu]

Counterpart of ``gmf_tpu/eval/test_recurrent.py`` (reference:
GMF_PointDSC/evaluation/test_3DMatch_recurrent.py:230-284): evaluate each
checkpoint (a port or ``gmf_tpu`` checkpoint directory or a reference
``.pkl``) of the
directory in its own recorded modes, log its recall and the best. An
entry that does not load as a checkpoint is logged and skipped. Runs on
the card unless ``--cpu``.
"""

from __future__ import annotations

import argparse
import glob
import logging
import os


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--snapshot-dir", required=True,
                    help="directory of checkpoint subdirs / .pkl files")
    ap.add_argument("--descriptor", default="fcgf")
    ap.add_argument("--num-node", default="all")
    ap.add_argument("--scenes", nargs="*", default=None)
    ap.add_argument("--batch", type=int, default=1,
                    help="pairs per batched forward")
    ap.add_argument("--inflight", type=int, default=1,
                    help="batched dispatches kept in flight")
    ap.add_argument("--workers", type=int, default=0,
                    help="threaded pair prefetch")
    ap.add_argument("--device-match", action="store_true",
                    help="build correspondences on the card")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the card)")
    return ap.parse_args(argv)


def main(argv=None):
    """Returns (best checkpoint, its recall in %)."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    log = logging.getLogger("recurrent")

    from gmf_tpu_torch.data.threedmatch import SCENE_LIST, ThreeDMatchTest
    from gmf_tpu_torch.eval.harness import aggregate_scenes, evaluate_pairs
    from gmf_tpu_torch.eval.registration import PointDSCRegistrar
    from gmf_tpu_torch.utils.device import resolve_device
    from gmf_tpu_torch.utils.model_io import load_pointdsc

    device = resolve_device("cpu" if args.cpu else None)
    ckpts = sorted(
        p for p in glob.glob(os.path.join(args.snapshot_dir, "*"))
        if os.path.isdir(p) or p.endswith(".pkl"))
    log.info(f"sweeping {len(ckpts)} checkpoints")

    num_node = args.num_node if args.num_node == "all" else int(args.num_node)
    best = (None, -1.0)
    for ckpt in ckpts:
        try:
            model = load_pointdsc(ckpt, device=device)
        except Exception as e:  # a sweep goes on past a non-checkpoint
            log.info(f"skip {ckpt}: {e!r}")
            continue
        registrar = PointDSCRegistrar(model)
        all_stats = {}
        for si, scene in enumerate(args.scenes or SCENE_LIST):
            ds = ThreeDMatchTest(root=args.root, descriptor=args.descriptor,
                                 num_node=num_node, select_scene=scene,
                                 device_match=args.device_match)
            all_stats[scene] = evaluate_pairs(
                registrar, ds, scene_index=si, batch_size=args.batch,
                workers=args.workers, inflight=args.inflight)
        agg = aggregate_scenes(all_stats)
        log.info(f"{os.path.basename(ckpt)}: recall={agg['recall_pct']:.2f}%")
        if agg["recall_pct"] > best[1]:
            best = (ckpt, agg["recall_pct"])
    log.info(f"BEST: {best[0]} recall={best[1]:.2f}%")
    return best


if __name__ == "__main__":
    main()
