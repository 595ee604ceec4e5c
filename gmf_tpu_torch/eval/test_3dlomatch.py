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
FCGF weights: RR 33.69% (RE 3.64 deg, TE 11.12 cm). ``--mesh N`` shards
each batch over N ranks; ``--ring N`` runs every NonLocal layer as ring
attention over N ranks (``parallel/ring_attention.py``), the tokens of a
pair split over them, for megapairs whose attention outgrows one card:
the buckets are then the multiples of N, with buckets past 12000 for
``--num-node all``. The two exclude each other; both start a world of N
ranks as ``eval/cli.py`` says.
"""

from __future__ import annotations

import argparse


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
                    help="every NonLocal layer as ring attention over N "
                         "cards (N CPU ranks under --cpu): the tokens of a "
                         "pair split over them; buckets restricted to "
                         "multiples of N. Excludes --mesh")
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
    from gmf_tpu_torch.eval.cli import (eval_mesh, in_world,
                                        load_eval_model, save_stats,
                                        setup_logging)

    buckets = None
    if args.ring:
        if args.mesh:
            raise SystemExit("--ring (SP over tokens) and --mesh (DP over "
                             "pairs) are mutually exclusive")
        buckets = ring_buckets(args.ring, args.num_node)
    n = args.ring or args.mesh
    res = in_world("gmf_tpu_torch.eval.test_3dlomatch", argv, n, args.cpu,
                   flag="--ring" if args.ring else "--mesh")
    if res is not None:
        return res
    log = setup_logging("lomatch")

    from gmf_tpu_torch.data.threedmatch import ThreeDLoMatchTest
    from gmf_tpu_torch.eval.harness import (aggregate_scenes, evaluate_pairs,
                                            format_report)
    from gmf_tpu_torch.eval.registration import (DeviceFragmentCache,
                                                 PointDSCRegistrar)
    from gmf_tpu_torch.eval.solvers import make_register_fn

    model = load_eval_model(args, args.checkpoint)
    if args.ring:
        from gmf_tpu_torch.parallel.mesh import make_mesh

        model.ring_mesh = make_mesh(n_data=args.ring, device=model.device)
    num_node = args.num_node if args.num_node == "all" else int(args.num_node)
    frag_cache = (DeviceFragmentCache(args.frag_cache_mb << 20)
                  if args.device_match and args.frag_cache_mb else None)
    reg_kw = {} if buckets is None else {"buckets": buckets}
    registrar = PointDSCRegistrar(model, frag_cache=frag_cache,
                                  mesh=eval_mesh(args, model.device),
                                  **reg_kw)
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


def ring_buckets(n: int, num_node: str):
    """The buckets of a ring of ``n``: those that divide by it, and for
    ``num_node='all'`` the megapair buckets past 12000 that do
    (gmf_tpu/eval/test_3dlomatch.py:120-128)."""
    from gmf_tpu_torch.data.collate import BUCKETS

    buckets = [b for b in BUCKETS if b % n == 0]
    if num_node == "all":
        buckets += [b for b in (16384, 32768, 65536, 131072) if b % n == 0]
    if not buckets:
        raise SystemExit(f"--ring {n}: no bucket divides by the ring")
    return tuple(sorted(buckets))


if __name__ == "__main__":
    main()
