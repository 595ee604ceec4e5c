"""Time the cached attention backward kernels of two builds of gmf_tpu_torch
on one card, in turns, and check that the streaming backward kernels are the
same code.

    python -m gmf_tpu_torch.tools.compare_backward_builds --base DIR [--out PATH]

DIR is an unpacked checkout of another commit (``git archive``); the two
builds are loaded and timed by ``gmf_tpu_torch.tools.build_compare``.

1. Builds both trees' kernels, each timed (seconds, wall clock; zero where
   the library was already built).
2. At the training shape, 16 pairs of N=1000, D=128, the last tenth of
   pair 0 masked, for q/k/v in f32 and bf16 and the cache in f32, bf16 and
   int8: the forward's out and lse from this tree's cached forward, then,
   for each of the two cached backward kernels (dK/dV and dQ, PERF.md
   section 6 rows 7 and 8), REPS launches of the base, of this tree, of
   this tree again and of the base (CUDA events, after one warm launch
   each), and each build's largest error against the plain backward
   (``compat_attention_bwd_plain``) beside the card checks' limit (f32:
   1e-5 of the largest entry; bf16: 4 bf16 ulps of it). This tree's two
   launches must give the same bits.
3. Compares the SASS of the streaming backward kernels (rows 2 and 3, the
   ``compat_flash_bwd_dkv`` and ``compat_flash_bwd_dq`` instances both
   libraries hold; ``cuobjdump -sass``, file hashes masked).

Prints the card (nvidia-smi), one line per case and one JSON line; exits
non-zero if this tree misses a limit, two of its launches differ or a
streaming kernel's SASS differs.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path

import torch

from gmf_tpu_torch.tools.build_compare import (card, first_diff, load_build,
                                               open_lib, sass, speedup,
                                               time_turns)

B, N, D = 16, 1000, 128  # the training path's shape
REPS = 10
TYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
CACHES = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}


def bf16_ulp(x: float) -> float:
    """Spacing of bf16 values (8 significant bits) at |x|."""
    return 2.0 ** (math.floor(math.log2(abs(x))) - 7)


def limit(ref, dtype) -> float:
    scale = ref.float().abs().max().item()
    return 1e-5 * scale if dtype == torch.float32 else 4 * bf16_ulp(scale)


def cases(dtype, cdt, dev, gen):
    """{kernel: (run(lib), outputs, plain outputs)} of the two cached
    backward kernels on one set of inputs."""
    from gmf_tpu_torch.ops.fused_attention import (
        _CACHE_TYPES, _cached_forward, _qscale, build_compat_cache,
        bwd_inputs, compat_attention_bwd_plain)

    q, k, v, do = (torch.randn(B, N, D, generator=gen, device=dev).to(dtype)
                   for _ in range(4))
    src = 3.0 * torch.rand(B, N, 3, generator=gen, device=dev)
    tgt = src + 0.05 * torch.randn(B, N, 3, generator=gen, device=dev)
    mask = torch.ones(B, N, device=dev)
    mask[0, N - N // 10:] = 0.0
    cache = build_compat_cache(src, tgt, 0.10, cdt)
    out, lse = _cached_forward(q, k, v, cache, mask, True)
    inp = bwd_inputs(q, k, v, do, out, lse, mask)
    ref_q, ref_k, ref_v = compat_attention_bwd_plain(q, k, v, do, out, lse,
                                                     mask, compat=cache)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    head = [inp[n].data_ptr() for n in ("q", "k", "v", "do", "lse", "delta")]
    tail = [B, N, D, cache.shape[-1], int(dtype == torch.bfloat16),
            _CACHE_TYPES[cdt], _qscale(D), 1.0 / math.sqrt(D)]

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def run_dkv(lib):
        return lib.gmf_compat_flash_attention_cached_bwd_dkv(
            *head, cache.data_ptr(), inp["mask"].data_ptr(), dk.data_ptr(),
            dv.data_ptr(), *tail, stream())

    def run_dq(lib):
        return lib.gmf_compat_flash_attention_cached_bwd_dq(
            *head, cache.data_ptr(), inp["mask"].data_ptr(), dq.data_ptr(),
            *tail, stream())

    return {"dkv": (run_dkv, (dk, dv), (ref_k, ref_v)),
            "dq": (run_dq, (dq,), (ref_q,))}


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
        for cname, cdt in CACHES.items():
            for kernel, (run, outs, refs) in cases(dtype, cdt, dev,
                                                  gen).items():
                tag = f"{kernel}_{tname}_{cname}"
                base_err, _ = errors(libs["base"], run, outs, refs, dtype)
                this_err, got = errors(libs["this"], run, outs, refs, dtype)
                _, again = errors(libs["this"], run, outs, refs, dtype)
                same = all(torch.equal(a, b) for a, b in zip(got, again))
                t = time_turns(libs, run, REPS)
                rows[tag] = dict(base_ms=t["base"], this_ms=t["this"],
                                 speedup=speedup(t),
                                 base_err_over_limit=base_err,
                                 this_err_over_limit=this_err,
                                 this_same_bits=same)
                ok &= this_err <= 1.0 and same
                print(f"{tag}: {json.dumps(rows[tag])}", flush=True)
            torch.cuda.empty_cache()

    base_sass, this_sass = sass(paths["base"]), sass(paths["this"])
    stream = sorted(n for n in set(base_sass) & set(this_sass)
                    if "compat_flash_bwd_d" in n and "_tc" not in n)
    differ = [n for n in stream if base_sass[n] != this_sass[n]]
    print(f"SASS: {len(stream)} streaming backward kernels in both builds, "
          f"{len(differ)} differ", flush=True)
    for n in differ[:4]:
        print(f"  {n}: {first_diff(base_sass[n], this_sass[n])}", flush=True)
    ok &= bool(stream) and not differ

    res = dict(card=device, batch=B, num_corr=N, d=D, reps=REPS,
               build_s=build_s, rows=rows, sass_stream_kernels=stream,
               sass_stream_differ=differ, ok=ok)
    if args.out:
        Path(args.out).write_text(json.dumps(res, indent=1))
    print(json.dumps(res), flush=True)
    if not ok:
        sys.exit("compare_backward_builds: a limit, the bits of two launches "
                 "or the streaming kernels' SASS failed")


if __name__ == "__main__":
    main()
