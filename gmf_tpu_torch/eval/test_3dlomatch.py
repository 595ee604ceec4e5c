"""3DLoMatch (low-overlap) evaluation command line on the card.

    python -m gmf_tpu_torch.eval.test_3dlomatch --root /path \\
        --pair-file 3DLoMatch.pkl --checkpoint snapshot/model_best \\
        [--num-node all]

Counterpart of ``gmf_tpu/eval/test_3dlomatch.py`` (reference:
GMF_PointDSC/evaluation/test_3DLoMatch.py): the pair list of a PREDATOR
pair file, 5000 keypoints a fragment by default. With ``--num-node all``
a pair keeps every mutual match; past the largest bucket (12000) the
registrar opens one of the next multiple of 4096, and past 16384 points a
pair NMS runs its merge pass. The reference's output for its released
FCGF weights: RR 33.69% (RE 3.64 deg, TE 11.12 cm). ``--ring`` (ring
attention over a mesh) and ``--mesh`` wait for ``parallel/`` and stop by
name.
"""

from __future__ import annotations

import argparse
import logging


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--pair-file", required=True, help="3DLoMatch.pkl")
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--descriptor", default="fcgf")
    ap.add_argument("--num-node", default="5000")
    ap.add_argument("--re-thre", type=float, default=15.0)
    ap.add_argument("--te-thre", type=float, default=30.0)
    ap.add_argument("--out", default="eval_3dlomatch")
    ap.add_argument("--ring", type=int, default=0, metavar="N",
                    help="ring attention over an N-card mesh (not ported "
                         "yet: refused)")
    ap.add_argument("--device-match", action="store_true",
                    help="build correspondences on the card in the "
                         "registrar's call")
    ap.add_argument("--frag-cache-mb", type=int, default=4096,
                    help="device fragment-cache budget for --device-match "
                         "(MB); 0 disables")
    from gmf_tpu_torch.eval.cli import add_model_args

    add_model_args(ap)
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    log = logging.getLogger("lomatch")

    from gmf_tpu_torch.eval.cli import load_eval_model, refuse, save_stats

    if args.ring:
        refuse("--ring")

    from gmf_tpu_torch.data.threedmatch import ThreeDLoMatchTest
    from gmf_tpu_torch.eval.harness import (aggregate_scenes, evaluate_pairs,
                                            format_report)
    from gmf_tpu_torch.eval.registration import (DeviceFragmentCache,
                                                 PointDSCRegistrar)
    from gmf_tpu_torch.eval.solvers import make_register_fn

    model = load_eval_model(args, args.checkpoint)
    num_node = args.num_node if args.num_node == "all" else int(args.num_node)
    frag_cache = (DeviceFragmentCache(args.frag_cache_mb << 20)
                  if args.device_match and args.frag_cache_mb else None)
    registrar = PointDSCRegistrar(model, frag_cache=frag_cache)
    register_fn = make_register_fn(registrar)
    ds = ThreeDLoMatchTest(root=args.root, pair_file=args.pair_file,
                           num_node=num_node, descriptor=args.descriptor,
                           device_match=args.device_match)
    stats = evaluate_pairs(register_fn, ds, re_thresh=args.re_thre,
                           te_thresh_cm=args.te_thre, batch_size=args.batch,
                           workers=args.workers, inflight=args.inflight)
    agg = aggregate_scenes({"3dlomatch": stats})
    log.info(format_report(agg))
    save_stats(args.out, agg)
    return agg


if __name__ == "__main__":
    main()
