"""Time the seed stage's last two kernels, the hypothesis counts and the
fused seed solver, of two builds of gmf_tpu_torch on one card, in turns.

    python -m gmf_tpu_torch.tools.compare_seed_builds --base DIR [--out PATH]

DIR is an unpacked checkout of another commit (``git archive``); each
tree's kernels are built and loaded as ``gmf_tpu_torch.tools.
build_compare`` says. The two trees' entry points take the same
arguments.

Counts (``gmf_seed_hypothesis_counts``) at chip_smoke.py's shapes: B=8
pairs of N=5000 with pair 0 4000 valid; the serving path's 64 pairs of
5000, every pair its own count of valid rows; training's 16 pairs of
1000, the last tenth of pair 0 masked; S = N / 10 hypotheses a pair near
the identity, threshold 0.10. The seed solver (``gmf_fused_seed_weights``)
at B=8 and at 64 pairs of S=500 seeds, each seed's k=40 neighbours drawn
from its pair's 5000 unit features of depth 128 (by the kNN), in f32 and
in bf16, 10 iterations. For each: REPS launches of the base, this tree,
this tree and the base (CUDA events, after one warm launch each); each
build's output held to the plain version (counts: this tree equal in every
count, the base within its old limit of 2; weights within 1e-5). Prints
the card (nvidia-smi), one line per case and one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

from gmf_tpu_torch.tools.build_compare import (call, card, load_build,
                                               open_lib, speedup, time_turns)

REPS = 20
K = 40          # neighbours a seed keeps
C = 128         # feature depth
ITERS = 10
SIGMA = 1.2     # the learned feature sigma (chip_smoke.py's SEED_SIGMA)
COUNT_SHAPES = {"b8": (8, 5000), "b64": (64, 5000), "train_b16": (16, 1000)}
SOLVER_SHAPES = {"b8": 8, "b64": 64}
SOLVER_N, SOLVER_S = 5000, 500


def make_mask(shape: str, b: int, n: int, dev):
    mask = torch.ones(b, n, device=dev)
    if shape == "b8":
        mask[0, 4000:] = 0.0
    elif shape == "b64":
        valid = n - (torch.arange(b, device=dev) * 37) % 1000
        mask = (torch.arange(n, device=dev)[None] < valid[:, None]).float()
    else:
        mask[0, n - n // 10:] = 0.0
    return mask


def counts_inputs(shape: str, dev, gen):
    """(trans [b, s, 4, 4], src, tgt [b, n, 3], mask [b, n]): points in a
    3 m cube, tgt within ~8 cm of src, hypotheses turned ~0.02 rad about z
    and shifted ~2 cm from the identity."""
    b, n = COUNT_SHAPES[shape]
    s = n // 10
    src = 3.0 * torch.rand(b, n, 3, generator=gen, device=dev)
    tgt = src + 0.08 * torch.randn(b, n, 3, generator=gen, device=dev)
    a = 0.02 * torch.randn(b, s, generator=gen, device=dev)
    trans = torch.eye(4, device=dev).repeat(b, s, 1, 1)
    trans[..., 0, 0], trans[..., 0, 1] = a.cos(), -a.sin()
    trans[..., 1, 0], trans[..., 1, 1] = a.sin(), a.cos()
    trans[..., :3, 3] = 0.02 * torch.randn(b, s, 3, generator=gen, device=dev)
    return trans, src, tgt, make_mask(shape, b, n, dev)


def solver_inputs(b: int, dev, gen):
    """(feats [b, S, K, C] f32, src_knn, tgt_knn [b, S, K, 3]): each seed's
    K nearest features (by the kNN wrapper) among its pair's unit
    features, their keypoints in a 3 m cube, tgt within ~2 cm of a common
    rigid motion for two thirds of them."""
    from gmf_tpu_torch.ops.fused_topk import seed_knn_topk

    n, s = SOLVER_N, SOLVER_S
    feats = torch.randn(b, n, C, generator=gen, device=dev)
    feats = feats / feats.norm(dim=-1, keepdim=True)
    seed_idx = torch.randperm(n, generator=gen, device=dev)[:s]
    idx, _ = seed_knn_topk(feats[:, seed_idx].contiguous(), feats, K + 1)
    rows = (idx[..., 1:].long()
            + (torch.arange(b, device=dev) * n)[:, None, None]).reshape(-1)
    src = 3.0 * torch.rand(b, n, 3, generator=gen, device=dev)
    tgt = src + torch.tensor([0.2, -0.1, 0.4], device=dev)
    tgt = tgt + 0.02 * torch.randn(b, n, 3, generator=gen, device=dev)
    out = torch.rand(b, n, generator=gen, device=dev) < 0.33
    tgt = torch.where(out[..., None],
                      3.0 * torch.rand(b, n, 3, generator=gen, device=dev),
                      tgt)
    return (feats.reshape(b * n, C)[rows].reshape(b, s, K, C),
            src.reshape(b * n, 3)[rows].reshape(b, s, K, 3),
            tgt.reshape(b * n, 3)[rows].reshape(b, s, K, 3))


def counts_case(libs, shape: str, dev, gen):
    from gmf_tpu_torch.ops.fused_scoring import seed_hypothesis_counts_plain

    trans, src, tgt, mask = counts_inputs(shape, dev, gen)
    b, s = trans.shape[:2]
    n = src.shape[1]
    out = torch.empty(b, s, dtype=torch.int32, device=dev)

    def run(lib):
        return lib.gmf_seed_hypothesis_counts(
            trans.data_ptr(), src.data_ptr(), tgt.data_ptr(),
            mask.data_ptr(), out.data_ptr(), b, s, n, 0.10 ** 2,
            torch.cuda.current_stream().cuda_stream)

    ref = torch.cat([seed_hypothesis_counts_plain(
        trans[p:p + 8], src[p:p + 8], tgt[p:p + 8], 0.10, mask=mask[p:p + 8])
        for p in range(0, b, 8)])
    row = {"pairs": b, "seeds": s, "points": n,
           "mean_count": ref.float().mean().item()}
    for who in ("base", "this"):
        call(libs[who], run)
        row[f"{who}_max_abs_err"] = (out - ref).abs().max().item()
    turns = time_turns(libs, run, REPS)
    row.update(base_ms=turns["base"], this_ms=turns["this"],
               speedup=speedup(turns))
    if row["this_max_abs_err"] != 0 or row["base_max_abs_err"] > 2:
        sys.exit(f"compare_seed_builds: counts {shape}: {row}")
    return row


def solver_case(libs, b: int, dtype, dev, gen):
    from gmf_tpu_torch.ops.fused_seed_solver import fused_seed_weights_plain

    feats, src, tgt = solver_inputs(b, dev, gen)
    feats = feats.to(dtype).contiguous()
    sigma = torch.tensor([SIGMA], device=dev)
    out = torch.empty(b, SOLVER_S, K, device=dev)

    def run(lib):
        return lib.gmf_fused_seed_weights(
            feats.data_ptr(), src.data_ptr(), tgt.data_ptr(),
            sigma.data_ptr(), out.data_ptr(), b * SOLVER_S, K, C,
            int(dtype == torch.bfloat16), 0.10 ** 2, ITERS,
            torch.cuda.current_stream().cuda_stream)

    ref = torch.cat([fused_seed_weights_plain(
        feats[p:p + 8], src[p:p + 8], tgt[p:p + 8], sigma, 0.10, ITERS)
        for p in range(0, b, 8)])
    row = {"pairs": b, "seeds": SOLVER_S, "k": K, "depth": C,
           "dtype": str(dtype).split(".")[-1]}
    for who in ("base", "this"):
        call(libs[who], run)
        row[f"{who}_max_abs_err"] = (out - ref).abs().max().item()
    turns = time_turns(libs, run, REPS)
    row.update(base_ms=turns["base"], this_ms=turns["this"],
               speedup=speedup(turns))
    if max(row["base_max_abs_err"], row["this_max_abs_err"]) > 1e-5:
        sys.exit(f"compare_seed_builds: solver B={b} {dtype}: {row}")
    return row


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--base", required=True, type=Path,
                    help="unpacked checkout of the commit to compare with")
    ap.add_argument("--out", help="also write the JSON result here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("compare_seed_builds: needs a CUDA card")
    device = card()
    print(device, flush=True)
    root = Path(__file__).resolve().parents[2]
    libs = {"base": open_lib(load_build(args.base.resolve(), "base_build"))[0],
            "this": open_lib(load_build(root, "this_build"))[0]}
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    result = {"card": device, "reps": REPS, "counts": {}, "solver": {}}
    for shape in COUNT_SHAPES:
        result["counts"][shape] = row = counts_case(libs, shape, dev, gen)
        print(f"counts {shape}: {json.dumps(row)}", flush=True)
    for shape, b in SOLVER_SHAPES.items():
        for dtype in (torch.float32, torch.bfloat16):
            tag = f"{shape}_{str(dtype).split('.')[-1]}"
            result["solver"][tag] = row = solver_case(libs, b, dtype, dev,
                                                      gen)
            print(f"solver {tag}: {json.dumps(row)}", flush=True)
            torch.cuda.empty_cache()
    if args.out:
        Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
