"""What the evaluation command lines share: the model and dispatch flags,
loading the model on the card (or, with ``--cpu``, the CPU), running over
a world of ranks, and saving the statistics.

The JAX command lines pick ``--fused`` and ``--bf16`` by backend; here
both default to on for the card and off under ``--cpu``, and the model
takes the resolved value of each (a checkpoint's recorded mode included).
``--mesh N`` shards each batch over N ranks (``parallel/mesh.py``): a
command started outside a world of N ranks starts one through
``parallel/launch.py`` (N cards, or N CPU ranks under ``--cpu``) and
runs itself on every rank; rank 0 alone logs and writes, and its result
is the command's. Under ``torchrun`` (a world already joined through
``launch.init_world``) it runs on the ranks it is given.
"""

from __future__ import annotations

import argparse
import importlib
import logging
import os

import numpy as np
import torch


def add_device_arg(ap: argparse.ArgumentParser) -> None:
    """``--cpu``, the device flag every eval CLI shares."""
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU through the kernels' plain "
                         "versions (default: the card)")


def add_model_args(ap: argparse.ArgumentParser) -> None:
    """Device, model-mode and dispatch flags of the PointDSC eval CLIs."""
    add_device_arg(ap)
    ap.add_argument("--fused", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="the attention and NMS kernels (default: on for "
                         "the card, off under --cpu)")
    ap.add_argument("--bf16", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="bf16 module compute, f32 geometry (default: on "
                         "for the card, off under --cpu)")
    ap.add_argument("--compat-cache", default="auto",
                    choices=("auto", "off", "bf16", "f32", "int8"),
                    help="spatial-consistency cache mode ('auto' sizes it "
                         "by the batch, models/pointdsc.py)")
    ap.add_argument("--approx-knn", action="store_true",
                    help="the seed kNN's 'approx' mode (in the port an "
                         "exact top-k, ties in any order)")
    ap.add_argument("--batch", type=int, default=1,
                    help="pairs per batched forward (same-bucket pairs)")
    ap.add_argument("--mesh", type=int, default=0,
                    help="shard batches over an N-card 'data' mesh (N CPU "
                         "ranks under --cpu)")
    ap.add_argument("--inflight", type=int, default=1,
                    help="batched dispatches kept in flight (every result "
                         "is still fetched and scored)")
    ap.add_argument("--workers", type=int, default=0,
                    help="prefetch pairs with N threads")


def _run_rank(rank, world, module, argv):
    return importlib.import_module(module).main(argv)


def in_world(module: str, argv, n: int, cpu: bool, flag: str = "--mesh"):
    """Run ``module.main(argv)`` over a world of ``n`` ranks when this
    process is not one of such a world: the launch's rank-0 result, or
    None when the caller is to go on here (``n`` <= 1, or a world of
    ``n`` ranks is already joined). ``n`` cards are needed on the card,
    as gmf_tpu needs ``n`` devices."""
    import sys

    from gmf_tpu_torch.parallel.launch import launch
    from gmf_tpu_torch.parallel.mesh import world_initialized

    argv = sys.argv[1:] if argv is None else list(argv)
    if world_initialized():
        import torch.distributed as dist

        if dist.get_world_size() != n and n > 1:
            raise SystemExit(f"{flag} {n} in a world of "
                             f"{dist.get_world_size()} ranks")
        return None
    if n <= 1:
        return None
    if not cpu and torch.cuda.device_count() < n:
        raise SystemExit(f"{flag} {n} needs {n} cards, have "
                         f"{torch.cuda.device_count()}")
    return launch(_run_rank, n, module, argv,
                  device="cpu" if cpu else "cuda", timeout=24 * 3600.0)[0]


def is_chief() -> bool:
    """Whether this process logs and writes: rank 0, or no world."""
    from gmf_tpu_torch.parallel.mesh import world_initialized

    if not world_initialized():
        return True
    import torch.distributed as dist

    return dist.get_rank() == 0


def setup_logging(name: str) -> logging.Logger:
    """The command's logger: INFO on rank 0, warnings elsewhere."""
    logging.basicConfig(level=logging.INFO if is_chief() else
                        logging.WARNING, format="%(message)s")
    return logging.getLogger(name)


def eval_mesh(args, device):
    """The ``--mesh`` of an evaluation command (None without one)."""
    if not args.mesh:
        return None
    from gmf_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(n_data=args.mesh, device=device)


def load_eval_model(args, checkpoint: str, inlier_threshold: float = 0.10,
                    force=None):
    """The checkpoint's PointDSC on the resolved device in the flags'
    modes. ``inlier_threshold`` serves a checkpoint that records none;
    ``force`` (settings such as KITTI's thresholds) replaces what the
    checkpoint records."""
    from gmf_tpu_torch.models import PointDSC
    from gmf_tpu_torch.utils.device import resolve_device
    from gmf_tpu_torch.utils.model_io import load_pointdsc

    device = resolve_device("cpu" if args.cpu else None)
    on_card = device.type == "cuda"
    fused = on_card if args.fused is None else args.fused
    bf16 = on_card if args.bf16 is None else args.bf16
    kw = dict(device=device, fused_attention=fused,
              dtype=torch.bfloat16 if bf16 else torch.float32)
    if args.compat_cache != "auto":
        kw["compat_cache"] = args.compat_cache
    if args.approx_knn:
        kw["knn_topk"] = "approx"
    model = load_pointdsc(checkpoint, inlier_threshold=inlier_threshold,
                          **kw)
    if force:
        state = model.state_dict()
        model = PointDSC(**{**model.config, **force}, device=device,
                         dtype=kw["dtype"])
        model.load_state_dict(state)
    return model


def save_stats(out_dir: str, agg) -> str:
    """Write ``{out_dir}/all_stats.npy`` (rank 0 alone in a world)."""
    path = os.path.join(out_dir, "all_stats.npy")
    if is_chief():
        os.makedirs(out_dir, exist_ok=True)
        np.save(path, agg["all_stats"])
    return path
