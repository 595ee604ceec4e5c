"""KITTI evaluation command line (PointDSC+GMF) on the card.

    python -m gmf_tpu_torch.eval.test_kitti --root /path/kitti \\
        --checkpoint snapshot/model_best [--solver RANSAC] [--use-icp]

Counterpart of ``gmf_tpu/eval/test_kitti.py`` (reference:
GMF_PointDSC/evaluation/test_KITTI.py): 12000 correspondences a pair
without mutual matching, success = RE < 5 deg and TE < 60 cm, the model's
inlier threshold, sigma_d and NMS radius 1.2 m (test_KITTI.py:210-219),
labels at 0.6 m. The reference's output for its released FCGF weights:
"All 555 pairs, Mean Success Rate=98.38%". Runs on the card unless
``--cpu``.
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--descriptor", default="fcgf", choices=["fcgf", "fpfh"])
    ap.add_argument("--split", default="test")
    ap.add_argument("--num-node", type=int, default=12000)
    ap.add_argument("--use-mutual", action="store_true", default=False)
    ap.add_argument("--use-icp", action="store_true")
    ap.add_argument("--solver", default="SVD", choices=["SVD", "RANSAC"])
    ap.add_argument("--re-thre", type=float, default=5.0)
    ap.add_argument("--te-thre", type=float, default=60.0)
    ap.add_argument("--inlier-threshold", type=float, default=0.60)
    ap.add_argument("--out", default="eval_kitti")
    ap.add_argument("--device-match", action="store_true",
                    help="build correspondences on the card in the "
                         "registrar's call. Pairs with fewer than 10 "
                         "mutual matches are kept (non-mutual fallback on "
                         "the card) where the host loader draws another "
                         "pair, so degenerate pairs differ")
    from gmf_tpu_torch.eval.cli import add_model_args

    add_model_args(ap)
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from gmf_tpu_torch.eval.cli import (eval_mesh, in_world,
                                        load_eval_model, save_stats,
                                        setup_logging)

    res = in_world("gmf_tpu_torch.eval.test_kitti", argv, args.mesh,
                   args.cpu)
    if res is not None:
        return res
    log = setup_logging("evalkitti")

    from gmf_tpu_torch.data.kitti import KITTIDataset
    from gmf_tpu_torch.eval.harness import (aggregate_scenes, evaluate_pairs,
                                            format_report)
    from gmf_tpu_torch.eval.registration import PointDSCRegistrar
    from gmf_tpu_torch.eval.solvers import make_register_fn

    model = load_eval_model(
        args, args.checkpoint, inlier_threshold=1.2,
        force=dict(inlier_threshold=1.2, sigma_d=1.2, nms_radius=1.2))
    registrar = PointDSCRegistrar(
        model, match_inlier_threshold=args.inlier_threshold,
        match_mutual=args.use_mutual, mesh=eval_mesh(args, model.device))
    register_fn = make_register_fn(registrar, solver=args.solver,
                                   use_icp=args.use_icp,
                                   inlier_threshold=1.2)
    ds = KITTIDataset(root=args.root, split=args.split,
                      descriptor=args.descriptor, num_node=args.num_node,
                      use_mutual=args.use_mutual,
                      inlier_threshold=args.inlier_threshold,
                      device_match=args.device_match)
    stats = evaluate_pairs(register_fn, ds, re_thresh=args.re_thre,
                           te_thresh_cm=args.te_thre, batch_size=args.batch,
                           workers=args.workers, inflight=args.inflight)
    agg = aggregate_scenes({"kitti": stats})
    log.info(format_report(agg))
    save_stats(args.out, agg)
    return agg


if __name__ == "__main__":
    main()
