"""The classical baselines' evaluation command line (SM, PMC, RANSAC,
GC-RANSAC) on the card.

    python -m gmf_tpu_torch.eval.baseline_eval --root /path/3DImageMatch \\
        --methods SM RANSAC [--dataset 3dmatch|kitti]
    python -m gmf_tpu_torch.eval.baseline_eval ... --cpu   # on the CPU

Counterpart of ``gmf_tpu/eval/baseline_eval.py`` (GMF_PointDSC/
baseline_scripts/baseline_3DMatch.py:131-318 and baseline_KITTI.py): the
baselines (``eval/baselines.py``) under the 12-column harness of the
model evaluations, so that their rows compare with the models'. A method
whose dependency is missing (GC-RANSAC with neither the pygcransac
wheel nor a C++ compiler) is logged as SKIPPED. Each method's statistics
go to ``{out}/{METHOD}_stats.npy``; ``main(argv)`` returns
{method: aggregate} of the methods that ran.
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--dataset", default="3dmatch",
                    choices=["3dmatch", "kitti"])
    ap.add_argument("--methods", nargs="+",
                    default=["SM", "PMC", "RANSAC", "GCRANSAC"])
    ap.add_argument("--descriptor", default="fcgf", choices=["fcgf", "fpfh"])
    ap.add_argument("--num-node", default="all")
    ap.add_argument("--use-mutual", action="store_true", default=True)
    ap.add_argument("--no-mutual", dest="use_mutual", action="store_false")
    ap.add_argument("--inlier-threshold", type=float, default=None,
                    help="default 0.10 (3DMatch) / 0.60 (KITTI)")
    ap.add_argument("--max-iteration", type=int, default=5000)
    ap.add_argument("--re-thre", type=float, default=None)
    ap.add_argument("--te-thre", type=float, default=None)
    ap.add_argument("--out", default="eval_baselines")
    ap.add_argument("--scenes", nargs="*", default=None)
    from gmf_tpu_torch.eval.cli import add_device_arg

    add_device_arg(ap)
    return ap.parse_args(argv)


def main(argv=None):
    """Run the baselines (module docstring)."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    log = logging.getLogger("baselines")

    from gmf_tpu_torch.eval.baselines import (BaselineUnavailable,
                                              make_baseline_register_fn)
    from gmf_tpu_torch.eval.harness import (aggregate_scenes, evaluate_pairs,
                                            format_report)
    from gmf_tpu_torch.utils.device import resolve_device

    device = resolve_device("cpu" if args.cpu else None)
    if args.dataset == "3dmatch":
        from gmf_tpu_torch.data.threedmatch import SCENE_LIST, ThreeDMatchTest

        tau = args.inlier_threshold or 0.10
        re_thre = args.re_thre or 15.0
        te_thre = args.te_thre or 30.0
        scenes = args.scenes or SCENE_LIST
        num_node = (args.num_node if args.num_node == "all"
                    else int(args.num_node))

        def scene_pairs(scene):
            return ThreeDMatchTest(
                root=args.root, descriptor=args.descriptor,
                inlier_threshold=tau, num_node=num_node,
                use_mutual=args.use_mutual, select_scene=scene)
    else:
        from gmf_tpu_torch.data.kitti import KITTIDataset

        tau = args.inlier_threshold or 0.60
        re_thre = args.re_thre or 5.0
        te_thre = args.te_thre or 60.0
        scenes = ["kitti_test"]

        def scene_pairs(_):
            return KITTIDataset(
                root=args.root, split="test", descriptor=args.descriptor,
                inlier_threshold=tau,
                num_node=12000 if args.num_node == "all"
                else int(args.num_node),
                use_mutual=args.use_mutual)

    os.makedirs(args.out, exist_ok=True)
    results = {}
    for method in args.methods:
        try:
            register_fn = make_baseline_register_fn(
                method, inlier_threshold=tau,
                max_iteration=args.max_iteration, device=device)
        except BaselineUnavailable as e:
            log.info(f"[{method}] SKIPPED: {e}")
            continue
        all_stats = {}
        for si, scene in enumerate(scenes):
            ds = scene_pairs(scene)
            stats = evaluate_pairs(register_fn,
                                   (ds[i] for i in range(len(ds))),
                                   re_thresh=re_thre, te_thresh_cm=te_thre,
                                   scene_index=si)
            all_stats[scene] = stats
            log.info(f"[{method}] Scene {si}th: "
                     f"Reg Recall={stats[:, 0].mean() * 100:.2f}%")
        agg = aggregate_scenes(all_stats)
        log.info(f"==== {method} ====")
        log.info(format_report(agg))
        np.save(os.path.join(args.out, f"{method}_stats.npy"),
                agg["all_stats"])
        results[method] = agg
    log.info(f"stats saved under {args.out}/")
    return results


if __name__ == "__main__":
    main()
