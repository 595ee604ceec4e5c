"""What the evaluation command lines share: the model and dispatch flags,
loading the model on the card (or, with ``--cpu``, the CPU), and saving
the statistics.

The JAX command lines pick ``--fused`` and ``--bf16`` by backend; here
both default to on for the card and off under ``--cpu``, and the model
takes the resolved value of each (a checkpoint's recorded mode included).
``--mesh`` is the reference's data-parallel sharding, which waits for
``parallel/`` (ROADMAP queue 1 item 6): it stops the command by name.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

_NOT_PORTED = ("waits for the port of gmf_tpu/parallel/ (ROADMAP queue 1 "
               "item 6) and is not ported yet")


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
                    help="shard batches over an N-card mesh (not ported "
                         "yet: refused)")
    ap.add_argument("--inflight", type=int, default=1,
                    help="batched dispatches kept in flight (every result "
                         "is still fetched and scored)")
    ap.add_argument("--workers", type=int, default=0,
                    help="prefetch pairs with N threads")


def refuse(flag: str, why: str = _NOT_PORTED) -> None:
    raise SystemExit(f"{flag} {why}")


def load_eval_model(args, checkpoint: str, inlier_threshold: float = 0.10,
                    force=None):
    """The checkpoint's PointDSC on the resolved device in the flags'
    modes. ``inlier_threshold`` serves a checkpoint that records none;
    ``force`` (settings such as KITTI's thresholds) replaces what the
    checkpoint records."""
    from gmf_tpu_torch.models import PointDSC
    from gmf_tpu_torch.utils.device import resolve_device
    from gmf_tpu_torch.utils.model_io import load_pointdsc

    if args.mesh:
        refuse("--mesh")
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
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "all_stats.npy")
    np.save(path, agg["all_stats"])
    return path
