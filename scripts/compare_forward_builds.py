"""Time the forward attention kernels of two builds of gmf_tpu_torch on one
card, in turns, and check that their f32 instances are the same code.

    python scripts/compare_forward_builds.py --base DIR [--out PATH]

DIR is an unpacked checkout of another commit (``git archive``); the two
builds are loaded and timed by ``gmf_tpu_torch.tools.build_compare``.

1. Times, per forward instance at 64 x 5000 x 128 in bf16 (PERF.md section 6
   rows 1, 5, 6 on int8, bf16 and f32 caches, and the variant instances
   13 v0, v1, v3, v6), 5 launches of the base, of this tree, of
   this tree again and of the base (CUDA events, after one warm launch
   each), and the largest difference between the two builds' outputs.
   Random q, k, v, keypoints in a 3 m cube, no masked key.
2. Runs every f32 instance (streaming and cached with lse, build+attend
   with its cache, the four variants) of both builds at 4 x 1000 x D for
   D in 32, 128 with keys masked in pair 0 and holds them equal in every
   bit.
3. Compares the SASS of every kernel the two libraries share by name
   (``cuobjdump -sass``; the file hashes in the names and the numbers of
   the compiler's internal subroutines are masked) and prints the first
   differing lines of a few that differ.

Prints the card (nvidia-smi), one line per instance and one JSON line;
exits non-zero if an f32 output differs.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from gmf_tpu_torch.tools.build_compare import (  # noqa: E402
    call, card, first_diff, load_build, open_lib, sass, speedup, time_turns)

# the serving path's shape (the bench default), launches per timed turn
B, N, D = 64, 5000, 128
REPS = 5
SIGMA_SQ = 0.10 ** 2
CACHES = {"int8": torch.int8, "bf16": torch.bfloat16, "f32": torch.float32}


def instances(b, n, d, dtype, dev, gen, masked=False):
    """{name: (run(lib) -> outputs, outputs to compare)} of every forward
    instance on one set of inputs of ``dtype``."""
    from gmf_tpu_torch.ops.flash_variants import _VARIANT_IDS
    from gmf_tpu_torch.ops.fused_attention import (_CACHE_TYPES, _qscale,
                                                   build_compat_cache,
                                                   cache_row_stride)

    q, k, v = (torch.randn(b, n, d, generator=gen, device=dev).to(dtype)
               for _ in range(3))
    src = 3.0 * torch.rand(b, n, 3, generator=gen, device=dev)
    tgt = src + 0.05 * torch.randn(b, n, 3, generator=gen, device=dev)
    mask = torch.ones(b, n, device=dev)
    if masked:
        mask[0, n - n // 10:] = 0.0
        mask[0, 5:25] = 0.0
    bf16 = int(dtype == torch.bfloat16)
    qs = _qscale(d)
    stream = torch.cuda.current_stream().cuda_stream
    out = torch.empty_like(q)
    lse = torch.empty(b, n, device=dev)
    ld8 = cache_row_stride(n, torch.int8)
    built = torch.empty(b, n, ld8, dtype=torch.int8, device=dev)
    caches = {c: build_compat_cache(src, tgt, 0.10, dt)
              for c, dt in CACHES.items()}
    inputs = (q, k, v, src, tgt, mask)  # the closures keep them alive

    def P():
        return [x.data_ptr() for x in inputs]

    runs = {
        "compat_flash_attention": (lambda lib: lib.gmf_compat_flash_attention(
            *P(), out.data_ptr(), lse.data_ptr(), b, n, d, bf16, SIGMA_SQ, qs,
            stream), (out, lse)),
        "compat_flash_attention_build": (
            lambda lib: lib.gmf_compat_flash_attention_build(
                *P(), out.data_ptr(), built.data_ptr(), b, n, d, ld8, bf16,
                SIGMA_SQ, qs, stream), (out, built)),
    }
    for c, cache in caches.items():
        runs[f"compat_flash_attention_cached[{c}]"] = (
            lambda lib, cache=cache, ct=_CACHE_TYPES[cache.dtype]:
            lib.gmf_compat_flash_attention_cached(
                *P()[:3], cache.data_ptr(), mask.data_ptr(), out.data_ptr(),
                lse.data_ptr(), b, n, d, cache.shape[-1], bf16, ct, qs,
                stream), (out, lse))
    for name, vid in _VARIANT_IDS.items():
        runs[f"compat_flash_variant_{name}"] = (
            lambda lib, vid=vid: lib.gmf_compat_flash_variant(
                *P(), out.data_ptr(), b, n, d, vid, bf16, SIGMA_SQ, qs,
                stream), (out,))
    return runs


def outputs(lib, run, outs):
    call(lib, run)
    torch.cuda.synchronize()
    return [o.clone() for o in outs]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--base", required=True, type=Path,
                    help="unpacked checkout of the commit to compare with")
    ap.add_argument("--out", help="also write the JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("compare_forward_builds: needs a CUDA card")
    device = card()
    print(device, flush=True)
    dev = torch.device("cuda")
    paths, libs = {}, {}
    for who, tree in (("base", args.base.resolve()), ("this", ROOT)):
        libs[who], paths[who] = open_lib(load_build(tree, f"_build_{who}"))

    gen = torch.Generator(device=dev).manual_seed(0)
    rows, speedups = {}, {}
    runs = instances(B, N, D, torch.bfloat16, dev, gen)
    for name, (run, outs) in runs.items():
        ref = outputs(libs["base"], run, outs)
        got = outputs(libs["this"], run, outs)
        diff = max((g.float() - r.float()).abs().max().item()
                   for g, r in zip(got[:1], ref[:1]))
        t = time_turns(libs, run, REPS)
        rows[name] = dict(base_ms=t["base"], this_ms=t["this"],
                          max_abs_diff_out=diff)
        speedups[name] = speedup(t)
        if len(got) > 1 and got[1].dtype == torch.int8:
            rows[name]["cache_equal"] = torch.equal(got[1], ref[1])
        print(f"{name}: base {t['base']} ms, this {t['this']} ms, "
              f"max |out diff| {diff}", flush=True)
    del runs
    torch.cuda.empty_cache()

    f32_equal, ok = {}, True
    for d in (32, 128):
        runs = instances(4, 1000, d, torch.float32, dev, gen, masked=True)
        for name, (run, outs) in runs.items():
            same = all(torch.equal(g, r) for g, r in zip(
                outputs(libs["this"], run, outs),
                outputs(libs["base"], run, outs)))
            f32_equal[f"{name} D={d}"] = same
            ok &= same
    print(f"f32 instances equal in every bit: {all(f32_equal.values())} "
          f"({sum(f32_equal.values())}/{len(f32_equal)})", flush=True)

    base_sass, this_sass = sass(paths["base"]), sass(paths["this"])
    shared = sorted(set(base_sass) & set(this_sass))
    differ = [n for n in shared if base_sass[n] != this_sass[n]]
    f32_fwd = [n for n in shared if "compat_flash_fwdIf" in n]
    f32_differ = [n for n in f32_fwd if n in differ]
    print(f"SASS: {len(shared)} kernels in both builds, {len(differ)} "
          f"differ; f32 forward instances {len(f32_fwd)}, differing "
          f"{len(f32_differ)}", flush=True)
    for n in differ[:4]:
        print(f"  {n}: {first_diff(base_sass[n], this_sass[n])}", flush=True)

    res = dict(card=device, batch=B, num_corr=N, d=D, reps=REPS, rows=rows,
               f32_equal=f32_equal, sass_shared=len(shared),
               sass_differ=differ, sass_f32_forward=len(f32_fwd),
               sass_f32_differ=f32_differ,
               ok=ok, speedup=speedups)
    if args.out:
        Path(args.out).write_text(json.dumps(res, indent=1))
    print(json.dumps(res), flush=True)
    if not ok:
        sys.exit("compare_forward_builds: the f32 instances differ")


if __name__ == "__main__":
    main()
