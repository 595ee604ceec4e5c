"""Time the forward attention kernels of two builds of gmf_tpu_torch on one
card, in turns, hold both builds' f32 instances to the plain version, and
check that their bf16 instances are the same code.

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
   D in 32, 128 with keys masked in pair 0 and holds each build to the
   plain version: output and lse within 1e-5, the build+attend cache
   equal in every byte. Then times every f32 instance of both builds in
   turns as in step 1, at the training shape 16 x 1000 x 128 and at 8 x
   5000 x 128.
3. Compares the SASS of every kernel the two libraries share by name
   (``cuobjdump -sass``; the file hashes in the names and the numbers of
   the compiler's internal subroutines are masked) and prints the first
   differing lines of a few that differ. Every bf16 forward instance
   (``compat_flash_fwd_tc``) must be in both and unchanged.

Prints the card (nvidia-smi), one line per instance and one JSON line;
exits non-zero if an f32 output misses its limit or a bf16 forward
instance's SASS differs.
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
# the f32 instances' timed shapes: the training shape, the B=8 request's
F32_SHAPES = ((16, 1000), (8, 5000))
SIGMA_SQ = 0.10 ** 2
CACHES = {"int8": torch.int8, "bf16": torch.bfloat16, "f32": torch.float32}


def instances(b, n, d, dtype, dev, gen, masked=False):
    """({name: (run(lib) -> outputs, outputs to compare)} of every forward
    instance on one set of inputs of ``dtype``, the inputs: q, k, v, src,
    tgt, mask and the caches by name)."""
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
    return runs, dict(inputs=inputs, caches=caches)


def plain_outputs(name, ctx):
    """The plain version's outputs of instance ``name`` in the order of
    its run's outputs: (out, lse), (out, int8 cache) or (out,)."""
    from gmf_tpu_torch.ops.flash_variants import flash_variant_plain
    from gmf_tpu_torch.ops.fused_attention import (
        compat_attention_cached_plain, compat_attention_plain,
        compat_flash_attention_build_plain)

    q, k, v, src, tgt, mask = ctx["inputs"]
    if name == "compat_flash_attention":
        return compat_attention_plain(q, k, v, src, tgt, mask,
                                      return_lse=True)
    if name == "compat_flash_attention_build":
        return compat_flash_attention_build_plain(q, k, v, src, tgt, mask)
    if name.startswith("compat_flash_attention_cached["):
        cache = ctx["caches"][name.split("[")[1].rstrip("]")]
        return compat_attention_cached_plain(q, k, v, cache, mask,
                                             return_lse=True)
    variant = name.rsplit("_", 1)[1]
    return (flash_variant_plain(q, k, v, src, tgt, mask=mask,
                                variant=variant),)


def plain_errors(got, ref):
    """(largest output error, largest lse error or None, cache equal or
    None) of one build's outputs against the plain version's."""
    err = (got[0] - ref[0]).abs().max().item()
    if len(got) == 1:
        return err, None, None
    if got[1].dtype == torch.int8:
        return err, None, torch.equal(got[1], ref[1])
    return err, (got[1] - ref[1]).abs().max().item(), None


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
    runs, _ = instances(B, N, D, torch.bfloat16, dev, gen)
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

    f32_plain, ok = {}, True
    for d in (32, 128):
        runs, ctx = instances(4, 1000, d, torch.float32, dev, gen,
                              masked=True)
        for name, (run, outs) in runs.items():
            ref = plain_outputs(name, ctx)
            for who in ("base", "this"):
                err, lse_err, cache_eq = plain_errors(
                    outputs(libs[who], run, outs), ref)
                held = (err <= 1e-5 and (lse_err is None or lse_err <= 1e-5)
                        and cache_eq is not False)
                f32_plain[f"{who} {name} D={d}"] = dict(
                    max_abs_err=err, lse_max_abs_err=lse_err,
                    cache_equal=cache_eq, held=held)
                ok &= held
        del runs, ctx
    print(f"f32 instances within 1e-5 of the plain version: "
          f"{sum(r['held'] for r in f32_plain.values())}/{len(f32_plain)}; "
          f"largest error {max(r['max_abs_err'] for r in f32_plain.values())}",
          flush=True)
    f32_rows = {}
    for b, n in F32_SHAPES:
        runs, _ = instances(b, n, D, torch.float32, dev, gen)
        for name, (run, outs) in runs.items():
            t = time_turns(libs, run, REPS)
            f32_rows[f"{name} {b}x{n}"] = dict(base_ms=t["base"],
                                               this_ms=t["this"])
            speedups[f"{name} f32 {b}x{n}"] = speedup(t)
            print(f"{name} f32 {b}x{n}: base {t['base']} ms, this "
                  f"{t['this']} ms", flush=True)
        del runs
        torch.cuda.empty_cache()

    base_sass, this_sass = sass(paths["base"]), sass(paths["this"])
    shared = sorted(set(base_sass) & set(this_sass))
    differ = [n for n in shared if base_sass[n] != this_sass[n]]
    bf16_fwd = [n for n in set(base_sass) | set(this_sass)
                if "compat_flash_fwd_tc" in n]
    bf16_differ = [n for n in bf16_fwd if n not in shared or n in differ]
    ok &= bool(bf16_fwd) and not bf16_differ
    print(f"SASS: {len(shared)} kernels in both builds, {len(differ)} "
          f"differ; bf16 forward instances {len(bf16_fwd)}, differing or "
          f"in one build only {len(bf16_differ)}", flush=True)
    for n in differ[:4]:
        print(f"  {n}: {first_diff(base_sass[n], this_sass[n])}", flush=True)

    res = dict(card=device, batch=B, num_corr=N, d=D, reps=REPS, rows=rows,
               f32_rows=f32_rows, f32_plain=f32_plain,
               sass_shared=len(shared), sass_differ=differ,
               sass_bf16_forward=len(bf16_fwd), sass_bf16_differ=bf16_differ,
               ok=ok, speedup=speedups)
    if args.out:
        Path(args.out).write_text(json.dumps(res, indent=1))
    print(json.dumps(res), flush=True)
    if not ok:
        sys.exit("compare_forward_builds: an f32 instance misses the plain "
                 "version's limits or a bf16 forward instance's SASS differs")


if __name__ == "__main__":
    main()
