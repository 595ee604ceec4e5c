"""Time the seed-kNN kernel of two builds of gmf_tpu_torch on one card, in
turns.

    python -m gmf_tpu_torch.tools.compare_knn_builds --base DIR [--out PATH]

DIR is an unpacked checkout of another commit (``git archive``); each
tree's kernels are built and loaded as ``gmf_tpu_torch.tools.
build_compare`` says. A build whose ``gmf_seed_knn_topk`` takes no dtype
flag has one instance, f32; it is timed on the f32 features, which is
what the model fed it (it normalised the features in f32).

For each shape (chip_smoke.py's: B=8 pairs of N=5000 with pair 0 4000
valid; the serving path's 64 pairs of 5000, every pair its own count of
valid rows; training's 16 pairs of 1000, the last tenth of pair 0
masked), unit features of depth 128, S = N / 10 seeds per pair and k =
41: REPS launches of the base, of each instance of this tree, of this
tree again and of the base (CUDA events, after one warm launch each),
and each launch's chosen scores against the plain version (within 1e-5).
Prints the card (nvidia-smi), one line per shape and one JSON line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import sys
from pathlib import Path

import torch

from gmf_tpu_torch.tools.build_compare import card, load_build

K1 = 41  # neighbours a seed keeps: k + 1, the seed itself included
C = 128
REPS = 10
SHAPES = {"b8": (8, 5000), "b64": (64, 5000), "train_b16": (16, 1000)}


def open_lib(build):
    """(the kNN entry point of a tree's library, whether it takes a dtype
    flag)."""
    lib = ctypes.CDLL(str(build.build()))
    argtypes = build.SIGNATURES["gmf_seed_knn_topk"]
    fn = lib.gmf_seed_knn_topk
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn, len(argtypes) == 12


def inputs(shape: str, dev, gen):
    """(seeds, feats, mask) in f32 for one of SHAPES."""
    b, n = SHAPES[shape]
    mask = torch.ones(b, n, device=dev)
    if shape == "b8":
        mask[0, 4000:] = 0.0
    elif shape == "b64":
        valid = n - (torch.arange(b, device=dev) * 37) % 1000
        mask = (torch.arange(n, device=dev)[None] < valid[:, None]).float()
    else:
        mask[0, n - n // 10:] = 0.0
    feats = torch.randn(b, n, C, generator=gen, device=dev)
    feats = feats / feats.norm(dim=-1, keepdim=True)
    seed_idx = torch.randperm(int(mask.sum(-1).min()), generator=gen,
                              device=dev)[:n // 10]
    return feats[:, seed_idx].contiguous(), feats, mask


def runner(fn, flagged: bool, seeds, feats, mask):
    """A closure launching one kNN into its own outputs (it holds the
    tensors, so they outlive every launch)."""
    b, s, _ = seeds.shape
    n = feats.shape[1]
    idx = torch.empty(b, s, K1, dtype=torch.int32, device=feats.device)
    val = torch.empty(b, s, K1, device=feats.device)
    extra = [int(seeds.dtype == torch.bfloat16)] if flagged else []

    def run():
        code = fn(seeds.data_ptr(), feats.data_ptr(), mask.data_ptr(),
                  idx.data_ptr(), val.data_ptr(), b, s, n, C, K1, *extra,
                  torch.cuda.current_stream().cuda_stream)
        if code != 0:
            raise RuntimeError(f"gmf_seed_knn_topk: CUDA error {code}")
        return idx

    return run


def score_err(seeds, feats, mask, idx):
    """The chosen scores' largest gap from the plain version's."""
    from gmf_tpu_torch.ops.fused_topk import seed_knn_topk_plain

    err = 0.0
    for b0 in range(0, seeds.shape[0], 8):
        sl = slice(b0, b0 + 8)
        _, ref_v = seed_knn_topk_plain(seeds[sl], feats[sl], K1,
                                       mask=mask[sl])
        full = torch.matmul(seeds[sl].float(),
                            feats[sl].float().transpose(-1, -2))
        full = torch.where(mask[sl][:, None] > 0, full,
                           torch.full_like(full, -math.inf))
        got = full.gather(-1, idx[sl].long())
        err = max(err, (got - ref_v).abs().max().item())
    return err


def time_ms(run) -> float:
    run()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / REPS


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--base", required=True, type=Path,
                    help="unpacked checkout of the commit to compare with")
    ap.add_argument("--out", help="also write the JSON result here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("compare_knn_builds: needs a CUDA card")
    device = card()
    print(device, flush=True)
    root = Path(__file__).resolve().parents[2]
    base_fn, base_flag = open_lib(load_build(args.base.resolve(),
                                             "base_build"))
    this_fn, this_flag = open_lib(load_build(root, "this_build"))
    if not this_flag:
        sys.exit("compare_knn_builds: this tree's kNN takes no dtype flag")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    result = {"card": device, "reps": REPS, "k": K1, "shapes": {}}
    for shape in SHAPES:
        seeds, feats, mask = inputs(shape, dev, gen)
        bf = (seeds.bfloat16(), feats.bfloat16())
        runs = {"base_f32": (runner(base_fn, base_flag, seeds, feats, mask),
                             (seeds, feats)),
                "bf16": (runner(this_fn, True, *bf, mask), bf),
                "f32": (runner(this_fn, True, seeds, feats, mask),
                        (seeds, feats))}
        row = {"pairs": seeds.shape[0], "seeds": seeds.shape[1],
               "keys": feats.shape[1]}
        for name, (run, (s, f)) in runs.items():
            row[f"{name}_max_abs_err"] = score_err(s, f, mask, run())
        for name in ("bf16", "f32"):
            turns = [time_ms(runs["base_f32"][0]), time_ms(runs[name][0]),
                     time_ms(runs[name][0]), time_ms(runs["base_f32"][0])]
            row[f"{name}_turns_ms"] = turns
            row[f"{name}_speedup"] = (turns[0] + turns[3]) / (
                turns[1] + turns[2])
        print(f"{shape}: " + json.dumps(row), flush=True)
        for name, (_, (s, f)) in runs.items():
            if row[f"{name}_max_abs_err"] > 1e-5:
                sys.exit(f"compare_knn_builds: {shape} {name}: chosen "
                         "scores differ from the plain version's")
        result["shapes"][shape] = row
        del runs, seeds, feats, mask, bf
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
