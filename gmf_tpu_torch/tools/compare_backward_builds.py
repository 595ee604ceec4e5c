"""Time the attention backward kernels of two builds of gmf_tpu_torch on one
card, in turns, and check that the cached backward kernels are the same
code.

    python -m gmf_tpu_torch.tools.compare_backward_builds --base DIR [--out PATH]

DIR is an unpacked checkout of another commit (``git archive``); the two
builds are loaded and timed by ``gmf_tpu_torch.tools.build_compare``.

1. Builds both trees' kernels, each timed (seconds, wall clock; zero where
   the library was already built).
2. At the training shape, 16 pairs of N=1000, D=128, the last tenth of
   pair 0 masked, for q/k/v in f32 and bf16, on the streaming mode
   (compat from the keypoints) and on the cache in f32, bf16 and int8:
   the forward's out and lse from this tree's forward kernel of that
   mode, then, for each of the two backward kernels (dK/dV and dQ;
   PERF.md section 6 rows 2 and 3 streaming, 7 and 8 cached), REPS
   launches of the base, of this tree, of this tree again and of the base
   (CUDA events, after one warm launch each), each build's largest error
   against the plain backward (``compat_attention_bwd_plain``) beside the
   card checks' limit (f32: 1e-5 of the largest entry; bf16: 4 bf16 ulps
   of it), and whether the two builds' outputs are equal in every bit.
   This tree's two launches must give the same bits.
3. Compares the SASS of the cached backward kernels (rows 7 and 8, every
   ``compat_flash_bwd_dkv_tc`` and ``compat_flash_bwd_dq_tc`` instance on
   a cache; ``cuobjdump -sass``, keyed by kernel and template arguments,
   this tree's ``Compat::kCached`` argument left out), which must be
   unchanged.

Prints the card (nvidia-smi), one line per case and one JSON line; exits
non-zero if this tree misses a limit, two of its launches differ or a
cached kernel's SASS differs.
"""

from __future__ import annotations

import argparse
import json
import math
import re
import sys
import time
from pathlib import Path

import torch

from gmf_tpu_torch.tools.build_compare import (card, first_diff, load_build,
                                               open_lib, sass, speedup,
                                               time_turns)

B, N, D = 16, 1000, 128  # the training path's shape
SIGMA_D = 0.10
REPS = 10
TYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
# compat of each case: streaming (from the keypoints), or the cache's type
MODES = {"stream": None, "f32": torch.float32, "bf16": torch.bfloat16,
         "int8": torch.int8}
KCACHED = 2  # Compat::kCached's value (compat_flash_core.cuh)


def bf16_ulp(x: float) -> float:
    """Spacing of bf16 values (8 significant bits) at |x|."""
    return 2.0 ** (math.floor(math.log2(abs(x))) - 7)


def limit(ref, dtype) -> float:
    scale = ref.float().abs().max().item()
    return 1e-5 * scale if dtype == torch.float32 else 4 * bf16_ulp(scale)


def cases(dtype, cdt, dev, gen):
    """{kernel: (run(lib), outputs, plain outputs)} of the two backward
    kernels of one mode (``cdt`` None: streaming, else the cache's type)
    on one set of inputs."""
    from gmf_tpu_torch.ops.fused_attention import (
        _CACHE_TYPES, _cached_forward, _qscale, _streaming_forward,
        build_compat_cache, bwd_inputs, compat_attention_bwd_plain)

    q, k, v, do = (torch.randn(B, N, D, generator=gen, device=dev).to(dtype)
                   for _ in range(4))
    src = 3.0 * torch.rand(B, N, 3, generator=gen, device=dev)
    tgt = src + 0.05 * torch.randn(B, N, 3, generator=gen, device=dev)
    mask = torch.ones(B, N, device=dev)
    mask[0, N - N // 10:] = 0.0
    if cdt is None:
        cache = None
        out, lse = _streaming_forward(q, k, v, src, tgt, mask, SIGMA_D, True)
    else:
        cache = build_compat_cache(src, tgt, SIGMA_D, cdt)
        out, lse = _cached_forward(q, k, v, cache, mask, True)
    inp = bwd_inputs(q, k, v, do, out, lse, mask)
    ref_q, ref_k, ref_v = compat_attention_bwd_plain(
        q, k, v, do, out, lse, mask, src, tgt, SIGMA_D, compat=cache)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    bf16 = int(dtype == torch.bfloat16)
    scales = [_qscale(D), 1.0 / math.sqrt(D)]

    def head():
        """q, k, v, do, lse, delta: the closures keep ``inp`` alive"""
        return [inp[n].data_ptr()
                for n in ("q", "k", "v", "do", "lse", "delta")]

    def stream():
        return torch.cuda.current_stream().cuda_stream

    if cache is None:
        tail = [B, N, D, bf16, SIGMA_D ** 2, *scales]

        def run_dkv(lib):
            return lib.gmf_compat_flash_attention_bwd_dkv(
                *head(), src.data_ptr(), tgt.data_ptr(),
                inp["mask"].data_ptr(), dk.data_ptr(), dv.data_ptr(), *tail,
                stream())

        def run_dq(lib):
            return lib.gmf_compat_flash_attention_bwd_dq(
                *head(), src.data_ptr(), tgt.data_ptr(),
                inp["mask"].data_ptr(), dq.data_ptr(), *tail, stream())
    else:
        tail = [B, N, D, cache.shape[-1], bf16, _CACHE_TYPES[cdt], *scales]

        def run_dkv(lib):
            return lib.gmf_compat_flash_attention_cached_bwd_dkv(
                *head(), cache.data_ptr(), inp["mask"].data_ptr(),
                dk.data_ptr(), dv.data_ptr(), *tail, stream())

        def run_dq(lib):
            return lib.gmf_compat_flash_attention_cached_bwd_dq(
                *head(), cache.data_ptr(), inp["mask"].data_ptr(),
                dq.data_ptr(), *tail, stream())

    return {"dkv": (run_dkv, (dk, dv), (ref_k, ref_v)),
            "dq": (run_dq, (dq,), (ref_q,))}


def cached_instances(funcs):
    """{(kernel, T, D, CT): SASS} of the cached backward kernels among a
    library's ``sass(path, demangled=True)``: the parent's
    ``compat_flash_bwd_dkv_tc<T, D, CT>``, this tree's with a fourth
    argument, the mode, kept where it is Compat::kCached."""
    out = {}
    for name, lines in funcs.items():
        for anon in ("(anonymous namespace)::", "<unnamed>::"):
            name = name.replace(anon, "")
        m = re.search(r"(compat_flash_bwd_d(?:kv|q)_tc)<([^>]*)>", name)
        if m is None:
            continue
        args = [a.strip() for a in m.group(2).split(",")]
        if len(args) == 4:
            if not args[3].endswith((f"){KCACHED}", "kCached")):
                continue
            args = args[:3]
        out[(m.group(1), *args)] = lines
    return out


def errors(lib, run, outs, refs, dtype):
    """(largest error / limit over the outputs, outputs) of one launch."""
    if run(lib) != 0:
        raise RuntimeError("CUDA error at launch")
    torch.cuda.synchronize()
    got = [o.clone() for o in outs]
    worst = max((g.float() - r.float()).abs().max().item() / limit(r, dtype)
                for g, r in zip(got, refs))
    return worst, got


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--base", required=True, type=Path,
                    help="unpacked checkout of the commit to compare with")
    ap.add_argument("--out", help="also write the JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("compare_backward_builds: needs a CUDA card")
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
    gen = torch.Generator(device=dev).manual_seed(0)
    rows, ok = {}, True
    for tname, dtype in TYPES.items():
        for cname, cdt in MODES.items():
            for kernel, (run, outs, refs) in cases(dtype, cdt, dev,
                                                  gen).items():
                tag = f"{kernel}_{tname}_{cname}"
                base_err, base_got = errors(libs["base"], run, outs, refs,
                                            dtype)
                this_err, got = errors(libs["this"], run, outs, refs, dtype)
                _, again = errors(libs["this"], run, outs, refs, dtype)
                same = all(torch.equal(a, b) for a, b in zip(got, again))
                t = time_turns(libs, run, REPS)
                rows[tag] = dict(base_ms=t["base"], this_ms=t["this"],
                                 speedup=speedup(t),
                                 base_err_over_limit=base_err,
                                 this_err_over_limit=this_err,
                                 this_same_bits=same,
                                 builds_same_bits=all(
                                     torch.equal(a, b)
                                     for a, b in zip(got, base_got)))
                ok &= this_err <= 1.0 and same
                print(f"{tag}: {json.dumps(rows[tag])}", flush=True)
            torch.cuda.empty_cache()

    base_sass = cached_instances(sass(paths["base"], demangled=True))
    this_sass = cached_instances(sass(paths["this"], demangled=True))
    cached = sorted(set(base_sass) & set(this_sass))
    differ = [n for n in cached if base_sass[n] != this_sass[n]]
    print(f"SASS: {len(cached)} cached backward kernels in both builds "
          f"({len(base_sass)} in the base, {len(this_sass)} here), "
          f"{len(differ)} differ", flush=True)
    for n in differ[:4]:
        print(f"  {n}: {first_diff(base_sass[n], this_sass[n])}", flush=True)
    ok &= bool(cached) and len(cached) == len(base_sass) and not differ

    res = dict(card=device, batch=B, num_corr=N, d=D, reps=REPS,
               build_s=build_s, rows=rows,
               sass_cached_kernels=[" ".join(n) for n in cached],
               sass_cached_differ=[" ".join(n) for n in differ], ok=ok)
    if args.out:
        Path(args.out).write_text(json.dumps(res, indent=1))
    print(json.dumps(res), flush=True)
    if not ok:
        sys.exit("compare_backward_builds: a limit, the bits of two launches "
                 "or the cached kernels' SASS failed")


if __name__ == "__main__":
    main()
