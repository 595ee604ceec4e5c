"""Why the dense attention sums its f32 products in f64, measured on a card.

    python scripts/check_dense_products.py [--out PATH]

Needs one CUDA card; builds no kernel. Prints the card's name and power
limit, then:

1. The error of the f32 products of the dense attention's shape against
   the same products in f64: W V and W^T V with W a softmax [16, 1000,
   1000] and V [16, 1000, 128], on the card (the library's f32 GEMM) and
   on the CPU.
2. One dense f32 train step (16 pairs of N=1000, full width and depth,
   random weights from seed 0) on the card, held leaf by leaf to the same
   step in f64 on the CPU by chip_smoke.py's compare_train_step (the
   bound of its train_cpu_check), twice: with the port's products
   (``models/pointdsc.py::_product_f64``: f32 products summed in f64 and
   rounded once) and with plain f32 products. The kNN and scoring are
   the exact and dense modes, so that nothing needs building; they give
   no gradient.

The last line is a JSON object with every number.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from unittest import mock

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
from gmf_tpu_torch.models import pointdsc  # noqa: E402
from gmf_tpu_torch.utils.device import resolve_device  # noqa: E402


def gemm_errors(dev):
    """Max and mean |f32 product - f64 product| on the card and the CPU."""
    g = torch.Generator().manual_seed(0)
    W = torch.softmax(torch.randn(16, 1000, 1000, generator=g) * 3, -1)
    V = torch.randn(16, 1000, 128, generator=g)
    out = {}
    for name, a in (("W V", W), ("W^T V", W.transpose(-1, -2))):
        ref = torch.matmul(a.double(), V.double())
        for where, got in (
                ("cpu", torch.matmul(a, V)),
                ("card", torch.matmul(a.to(dev), V.to(dev)).cpu())):
            err = (got.double() - ref).abs()
            out[f"{name} {where}"] = dict(max=err.max().item(),
                                          mean=err.mean().item())
    return out


def train_check(dev, plain_products: bool):
    from gmf_tpu_torch.data.synthetic import SyntheticCorrespondenceLoader

    model = pointdsc.PointDSC(
        num_layers=12, num_channels=128, k=40, ratio=0.1, sigma_d=0.10,
        fused_attention=False, knn_topk="exact", hypo_scoring="dense",
        dtype=torch.float32, device=dev, seed=chip_smoke.SEED)
    batch = next(iter(SyntheticCorrespondenceLoader(
        batch_size=16, num_corr=1000, steps_per_epoch=1,
        image_hw=chip_smoke.IMAGE_HW, seed=chip_smoke.SEED)))
    product = torch.matmul if plain_products else pointdsc._product_f64
    with mock.patch.object(pointdsc, "_product_f64", product):
        runs = chip_smoke.cpu_reference_steps(model, batch, "auto")
        out = chip_smoke.compare_train_step(model, batch, runs)
    return {k: out[k] for k in (
        "ok", "loss_rel_err", "leaf_err_over_tol_max",
        "leaf_err_over_tol_median", "leaves_over_half_tol", "worst_leaf")}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the result JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("this script needs a CUDA card")
    dev = resolve_device("cuda")
    card = chip_smoke.nvidia_smi("name,power.limit")
    print(card, flush=True)
    torch.set_num_threads(8)
    result = dict(card=card, gemm=gemm_errors(dev))
    for name, e in result["gemm"].items():
        print(f"f32 {name}: max {e['max']:.3e}, mean {e['mean']:.3e}",
              flush=True)
    for name, plain in (("port", False), ("plain_f32", True)):
        t0 = time.perf_counter()
        result[f"train_{name}"] = row = train_check(dev, plain)
        print(f"dense train step, {name} products "
              f"({time.perf_counter() - t0:.1f} s): {json.dumps(row)}",
              flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
