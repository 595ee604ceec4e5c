"""Time the NMS kernel of two builds of gmf_tpu_torch on one card, in turns.

    python -m gmf_tpu_torch.tools.compare_nms_builds --base DIR [--out PATH]

DIR is an unpacked checkout of another commit (``git archive``). At the
serving shapes, 8 and 64 pairs of N=5000 synthetic correspondences
(``make_correspondence_problem``, as ``chip_smoke.py``), radius 0.10 and
random scores, and at 2 pairs of 20000 (two runs of the kernel's sort, one merge pass), it
times ``REPS`` calls of each build's NMS in the order base, this, this,
base (CUDA events, after one warm call): a build with ``gmf_nms_sort``
gets the sort and the scan, one without it its one entry point, which
takes the points alone. Then this build's sort alone and its scan alone.
Both builds' outputs must equal ``nms_local_max_plain`` in every bit (run
in slices of 8 pairs). Prints the card, one line per shape and one JSON
line; exits non-zero if an output differs.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

from gmf_tpu_torch.tools.build_compare import (card, load_build, open_lib,
                                               speedup, time_turns)

ROOT = Path(__file__).resolve().parents[2]
SHAPES = ((8, 5000), (64, 5000), (2, 20000))
RADIUS = 0.10
REPS = 20

def nms_call(lib, src, scores, out, keys, order):
    """One NMS of ``lib``: its sort and scan, or its one entry point;
    returns the first non-zero code."""
    b, n, _ = src.shape
    stream = torch.cuda.current_stream().cuda_stream
    if not hasattr(lib, "gmf_nms_sort"):
        return lib.gmf_nms_local_max(src.data_ptr(), scores.data_ptr(),
                                     out.data_ptr(), b, n, RADIUS ** 2,
                                     stream)
    code = lib.gmf_nms_sort(src.data_ptr(), scores.data_ptr(),
                            keys.data_ptr(), order.data_ptr(), b, n, stream)
    return code or lib.gmf_nms_scan(keys.data_ptr(), order.data_ptr(),
                                    out.data_ptr(), b, n, RADIUS ** 2, stream)


def alone(fn):
    """Mean ms of ``REPS`` calls of ``fn`` (CUDA events, one warm call)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / REPS


def main(argv=None):
    from gmf_tpu_torch.data.synthetic import make_correspondence_problem
    from gmf_tpu_torch.ops.fused_nms import nms_local_max_plain

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--base", required=True, type=Path,
                    help="unpacked checkout of the commit to compare with")
    ap.add_argument("--out", help="also write the JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("compare_nms_builds: needs a CUDA card")
    device = card()
    print(device, flush=True)
    dev = torch.device("cuda")
    trees = {"base": args.base.resolve(), "this": ROOT}
    libs = {who: open_lib(load_build(tree, f"_build_{who}"))[0]
            for who, tree in trees.items()}

    rows, ok = {}, True
    gen = torch.Generator(device=dev).manual_seed(2)
    for b, n in SHAPES:
        prob = make_correspondence_problem(np.random.RandomState(2),
                                           num_corr=n, inlier_ratio=0.4,
                                           image_hw=(8, 8), batch=b)
        src = torch.tensor(prob["src_keypts"], device=dev)
        scores = torch.randn(b, n, generator=gen, device=dev)
        ref = torch.cat([nms_local_max_plain(src[s0:s0 + 8],
                                             scores[s0:s0 + 8], RADIUS)
                         for s0 in range(0, b, 8)])
        out = torch.empty(b, n, device=dev)
        keys = torch.empty(b, n, 4, device=dev)
        order = torch.empty(b, n, dtype=torch.int32, device=dev)
        equal = {}
        for who, lib in libs.items():
            out.fill_(-1.0)
            code = nms_call(lib, src, scores, out, keys, order)
            torch.cuda.synchronize()
            equal[who] = code == 0 and torch.equal(out, ref)
            ok &= equal[who]

        t = time_turns(libs, lambda lib: nms_call(lib, src, scores, out,
                                                  keys, order), REPS)
        this, stream = libs["this"], torch.cuda.current_stream().cuda_stream
        rows[f"{b}x{n}"] = dict(
            base_ms=t["base"], this_ms=t["this"], speedup=speedup(t),
            this_sort_ms=alone(lambda: this.gmf_nms_sort(
                src.data_ptr(), scores.data_ptr(), keys.data_ptr(),
                order.data_ptr(), b, n, stream)),
            this_scan_ms=alone(lambda: this.gmf_nms_scan(
                keys.data_ptr(), order.data_ptr(), out.data_ptr(), b, n,
                RADIUS ** 2, stream)),
            local_maxima=int(ref.sum().item()), equal_to_plain=equal)
        print(f"nms {b}x{n}: {json.dumps(rows[f'{b}x{n}'])}", flush=True)
        del src, scores, ref, out, keys, order
        torch.cuda.empty_cache()
    res = dict(card=device, base=str(trees["base"]), radius=RADIUS, reps=REPS,
               rows=rows, ok=ok)
    if args.out:
        Path(args.out).write_text(json.dumps(res, indent=1))
    print(json.dumps(res), flush=True)
    if not ok:
        sys.exit("compare_nms_builds: an output differs from the plain "
                 "version")
    return res


if __name__ == "__main__":
    main()
