"""Time the standalone compat cache kernel of two builds of gmf_tpu_torch on
one card, in turns, and check that every other kernel is the same code.

    python -m gmf_tpu_torch.tools.compare_cache_builds --base DIR [--out PATH]

DIR is an unpacked checkout of another commit (``git archive``); the two
builds are loaded and timed by ``gmf_tpu_torch.tools.build_compare``. The
two trees' ``gmf_build_compat_cache`` take the same arguments.

1. Builds both trees' kernels, each timed (seconds, wall clock; zero where
   the library was already built).
2. For each case, the keypoints of chip_smoke.py at that shape (sigma_d
   0.10): B=8 pairs of N=5000 (kernel_phase's) in f32, bf16 and int8; the
   attention-variant microbenchmark's 64 pairs of 5000 in f32 and bf16;
   training's 16 pairs of 1000 (backward_phase's) in each type. Each
   build's cache is held to the plain version (``build_compat_cache_plain``,
   in slices of 8 pairs) in every byte, pad columns included; this tree's
   cache must also equal its transpose over [:N, :N], hold zeros in its pad
   columns and give the same bytes in two launches. Then REPS launches of
   the base, of this tree, of this tree again and of the base (CUDA events,
   after one warm launch each).
3. Counts the instructions an entry of this tree's cache kernel issues on
   its fast path, per instance (``entry_instructions``), and compares the
   SASS of every other kernel of the two libraries (``cuobjdump -sass``,
   keyed by the demangled kernel name and template arguments): each must
   be unchanged.

Prints the card (nvidia-smi), one line per case and one JSON line; exits
non-zero if a cache differs from the plain version, this tree's cache is
not symmetric, its pads are not zero, two of its launches differ, or
another kernel's SASS differs.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
import time
from pathlib import Path

import numpy as np
import torch

from gmf_tpu_torch.tools.build_compare import (call, card, first_diff,
                                               load_build, open_lib, sass,
                                               speedup, time_turns)

SIGMA_D = 0.10
REPS = 10
TYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}
# shape -> (pairs, correspondences, cache types)
CASES = {"b8": (8, 5000, ("f32", "bf16", "int8")),
         "b64": (64, 5000, ("f32", "bf16")),
         "train_b16": (16, 1000, ("f32", "bf16", "int8"))}
# the cache kernel's names in either tree; every other kernel keeps its SASS
CACHE_KERNELS = ("build_compat_cache_kernel", "compat_cache_tile_pairs")


def keypoints(shape: str, dev):
    """src, tgt [b, n, 3] f32 as chip_smoke.py makes them at that shape."""
    from gmf_tpu_torch.data.synthetic import make_correspondence_problem
    from gmf_tpu_torch.tools import bench_flash_variants as bench

    b, n, _ = CASES[shape]
    if shape == "b64":
        _, src, tgt = bench.make_inputs(b, n, dev)
        return src, tgt
    seed, ratio = (0, 0.4) if shape == "b8" else (3, 0.5)
    prob = make_correspondence_problem(np.random.RandomState(seed),
                                       num_corr=n, inlier_ratio=ratio,
                                       image_hw=(8, 8), batch=b)
    return (torch.tensor(prob["src_keypts"], device=dev),
            torch.tensor(prob["tgt_keypts"], device=dev))


def case(libs, shape: str, cname: str, src, tgt):
    from gmf_tpu_torch.ops.fused_attention import (
        _CACHE_TYPES, build_compat_cache_plain, cache_row_stride)

    cdt = TYPES[cname]
    b, n, _ = src.shape
    ld = cache_row_stride(n, cdt)
    out = torch.empty(b, n, ld, dtype=cdt, device=src.device)

    def run(lib):
        return lib.gmf_build_compat_cache(
            src.data_ptr(), tgt.data_ptr(), out.data_ptr(), b, n, ld,
            _CACHE_TYPES[cdt], SIGMA_D ** 2,
            torch.cuda.current_stream().cuda_stream)

    def equal_to_plain():
        return all(torch.equal(out[p:p + 8], build_compat_cache_plain(
            src[p:p + 8], tgt[p:p + 8], SIGMA_D, cdt))
            for p in range(0, b, 8))

    row = {"pairs": b, "num_corr": n, "ld": ld}
    out.fill_(1)
    call(libs["base"], run)
    row["base_equal_to_plain"] = equal_to_plain()
    base = out.clone()
    out.fill_(1)
    call(libs["this"], run)
    row["this_equal_to_plain"] = equal_to_plain()
    row["builds_equal"] = torch.equal(out, base)
    del base
    row["this_symmetric"] = all(
        torch.equal(out[p:p + 8, :, :n], out[p:p + 8, :, :n].transpose(1, 2))
        for p in range(0, b, 8))
    row["this_pads_zero"] = not out[:, :, n:].any().item()
    first = out.clone()
    out.fill_(1)
    call(libs["this"], run)
    row["this_two_launches_equal"] = torch.equal(out, first)
    del first
    turns = time_turns(libs, run, REPS)
    row.update(base_ms=turns["base"], this_ms=turns["this"],
               speedup=speedup(turns))
    return row


def entry_instructions(lines, sqrts: int, entries: int = 16) -> float:
    """Instructions an entry of a cache kernel issues on its fast path:
    those from the kernel's third MUFU.RSQ to the one ``entries`` entries
    on (``sqrts`` square roots an entry), less the slow-path blocks the
    fast path branches over (from a predicated BRA to the CALL of the IEEE
    sqrt or division subroutine and the jump back)."""
    ins = [ln for ln in lines if re.match(r"/\*[0-9a-f]{4,}\*/", ln)]
    rsq = [i for i, ln in enumerate(ins) if "MUFU.RSQ" in ln]
    skipped = set()
    for c in (i for i, ln in enumerate(ins) if "CALL.REL" in ln):
        start = c
        while start > 0 and not re.search(r"@!?P\d BRA", ins[start - 1]):
            start -= 1
        end = c
        for k in (1, 2):  # the jump back, after a MOV of the result
            if c + k < len(ins) and re.search(r"\bBRA\b", ins[c + k]) \
                    and "@" not in ins[c + k]:
                end = c + k
                break
        skipped.update(range(start, end + 1))
    a, b = rsq[2], rsq[2 + entries * sqrts]
    return sum(i not in skipped for i in range(a, b)) / entries


def other_kernels(funcs):
    """{demangled name: SASS} of a library's kernels but the cache's."""
    return {name: lines for name, lines in funcs.items()
            if not any(k in name for k in CACHE_KERNELS)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--base", required=True, type=Path,
                    help="unpacked checkout of the commit to compare with")
    ap.add_argument("--out", help="also write the JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("compare_cache_builds: needs a CUDA card")
    device = card()
    print(device, flush=True)
    root = Path(__file__).resolve().parents[2]
    libs, paths, build_s = {}, {}, {}
    for who, tree in (("base", args.base.resolve()), ("this", root)):
        build = load_build(tree, f"_build_{who}")
        t0 = time.perf_counter()
        build.build()
        build_s[who] = time.perf_counter() - t0
        libs[who], paths[who] = open_lib(build)
    print(f"build s: {json.dumps(build_s)}", flush=True)

    dev = torch.device("cuda")
    rows, ok = {}, True
    checks = ("base_equal_to_plain", "this_equal_to_plain", "builds_equal",
              "this_symmetric", "this_pads_zero", "this_two_launches_equal")
    for shape, (_, _, cnames) in CASES.items():
        src, tgt = keypoints(shape, dev)
        for cname in cnames:
            tag = f"{shape}_{cname}"
            rows[tag] = row = case(libs, shape, cname, src, tgt)
            ok &= all(row[c] for c in checks)
            print(f"{tag}: {json.dumps(row)}", flush=True)
            torch.cuda.empty_cache()
        del src, tgt

    this_funcs = sass(paths["this"], demangled=True)
    per_entry = {}
    for name, lines in this_funcs.items():
        m = re.search(CACHE_KERNELS[1] + r"<([^>]*)>", name)
        if m:  # the instance's cache type: one sqrt an entry for int8
            per_entry[m.group(1)] = entry_instructions(
                lines, 1 if m.group(1).endswith("char") else 2)
    print(f"fast-path instructions an entry: {json.dumps(per_entry)}",
          flush=True)
    base_sass = other_kernels(sass(paths["base"], demangled=True))
    this_sass = other_kernels(this_funcs)
    differ = sorted(n for n in base_sass
                    if n in this_sass and base_sass[n] != this_sass[n])
    missing = sorted(set(base_sass) ^ set(this_sass))
    print(f"SASS: {len(base_sass)} other kernels in the base, "
          f"{len(this_sass)} here, {len(differ)} differ, {len(missing)} in "
          "one build only", flush=True)
    for n in differ[:4]:
        print(f"  {n}: {first_diff(base_sass[n], this_sass[n])}", flush=True)
    ok &= bool(base_sass) and not differ and not missing

    res = dict(card=device, reps=REPS, build_s=build_s, rows=rows,
               entry_instructions=per_entry,
               sass_other_kernels=len(base_sass), sass_differ=differ,
               sass_one_build_only=missing, ok=ok)
    if args.out:
        Path(args.out).write_text(json.dumps(res, indent=1))
    print(json.dumps(res), flush=True)
    if not ok:
        sys.exit("compare_cache_builds: a cache check or another kernel's "
                 "SASS failed")


if __name__ == "__main__":
    main()
