"""3DMatch evaluation command line (PointDSC+GMF) on the card.

    python -m gmf_tpu_torch.eval.test_3dmatch --root /path/3DImageMatch \\
        --checkpoint snapshot/model_best [--descriptor fcgf] [--use-icp]
    python -m gmf_tpu_torch.eval.test_3dmatch ... --cpu   # on the CPU

Counterpart of ``gmf_tpu/eval/test_3dmatch.py`` (reference:
GMF_PointDSC/evaluation/test_3DMatch.py:120-277): the per-scene loop over
the 8-scene test split, 12-column statistics, scene and pair
aggregation, the statistics saved to ``{out}/all_stats.npy``. The
reference's output for its released FPFH weights: "All 1623 pairs, Mean
Reg Recall=81.45%". ``--checkpoint`` is a port or ``gmf_tpu`` checkpoint
directory or a reference torch ``state_dict`` (``utils/model_io.py``). ``--mesh N``
shards each batch over N ranks (``eval/cli.py``).
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--checkpoint", required=True,
                    help="port or gmf_tpu checkpoint dir or reference "
                    "torch .pkl/.pth")
    ap.add_argument("--descriptor", default="fcgf", choices=["fcgf", "fpfh"])
    ap.add_argument("--num-node", default="all")
    ap.add_argument("--use-mutual", action="store_true", default=True)
    ap.add_argument("--no-mutual", dest="use_mutual", action="store_false")
    ap.add_argument("--use-icp", action="store_true")
    ap.add_argument("--solver", default="SVD", choices=["SVD", "RANSAC"])
    ap.add_argument("--re-thre", type=float, default=15.0)
    ap.add_argument("--te-thre", type=float, default=30.0)
    ap.add_argument("--inlier-threshold", type=float, default=0.10)
    ap.add_argument("--out", default="eval_3dmatch")
    ap.add_argument("--scenes", nargs="*", default=None)
    ap.add_argument("--device-match", action="store_true",
                    help="build putative correspondences on the card in "
                         "the registrar's call (mutual 1-NN, labels, "
                         "corr_pos) instead of on the host")
    ap.add_argument("--frag-cache-mb", type=int, default=4096,
                    help="device fragment-cache budget for --device-match "
                         "(MB): each fragment crosses to the card once; "
                         "0 disables")
    from gmf_tpu_torch.eval.cli import add_model_args

    add_model_args(ap)
    return ap.parse_args(argv)


def main(argv=None):
    """Run the evaluation; returns the aggregate (``harness.
    aggregate_scenes``)."""
    args = parse_args(argv)
    from gmf_tpu_torch.eval.cli import (eval_mesh, in_world,
                                        load_eval_model, save_stats,
                                        setup_logging)

    res = in_world("gmf_tpu_torch.eval.test_3dmatch", argv, args.mesh,
                   args.cpu)
    if res is not None:
        return res
    log = setup_logging("eval3dmatch")

    from gmf_tpu_torch.data.threedmatch import SCENE_LIST, ThreeDMatchTest
    from gmf_tpu_torch.eval.harness import (aggregate_scenes, evaluate_pairs,
                                            format_report)
    from gmf_tpu_torch.eval.registration import (DeviceFragmentCache,
                                                 PointDSCRegistrar)
    from gmf_tpu_torch.eval.solvers import make_register_fn

    model = load_eval_model(args, args.checkpoint,
                            inlier_threshold=args.inlier_threshold)
    frag_cache = (DeviceFragmentCache(args.frag_cache_mb << 20)
                  if args.device_match and args.frag_cache_mb else None)
    registrar = PointDSCRegistrar(
        model, match_inlier_threshold=args.inlier_threshold,
        match_mutual=args.use_mutual, frag_cache=frag_cache,
        mesh=eval_mesh(args, model.device))
    register_fn = make_register_fn(registrar, solver=args.solver,
                                   use_icp=args.use_icp,
                                   inlier_threshold=args.inlier_threshold)

    scenes = args.scenes or SCENE_LIST
    num_node = args.num_node if args.num_node == "all" else int(args.num_node)
    all_stats = {}
    for si, scene in enumerate(scenes):
        ds = ThreeDMatchTest(root=args.root, descriptor=args.descriptor,
                             inlier_threshold=args.inlier_threshold,
                             num_node=num_node, use_mutual=args.use_mutual,
                             select_scene=scene,
                             device_match=args.device_match)
        stats = evaluate_pairs(register_fn, ds, re_thresh=args.re_thre,
                               te_thresh_cm=args.te_thre, scene_index=si,
                               batch_size=args.batch, workers=args.workers,
                               inflight=args.inflight)
        all_stats[scene] = stats
        ok = stats[stats[:, 0] == 1]
        log.info(
            f"Scene {si}th: Reg Recall={stats[:, 0].mean() * 100:.2f}% "
            f"Mean RE={ok[:, 1].mean() if len(ok) else float('nan'):.2f} "
            f"Mean TE={ok[:, 2].mean() if len(ok) else float('nan'):.2f}")

    agg = aggregate_scenes(all_stats)
    log.info("*" * 40)
    log.info(format_report(agg))
    log.info(f"stats saved to {save_stats(args.out, agg)}")
    return agg


if __name__ == "__main__":
    main()
