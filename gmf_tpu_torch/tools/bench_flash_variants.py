"""Forward-only microbenchmark of the compat attention's variants.

    python -m gmf_tpu_torch.tools.bench_flash_variants
    python -m gmf_tpu_torch.tools.bench_flash_variants --num-corr 300 \\
        --batch 2 --layers 2 --iters 1 --device cpu

Counterpart of ``scripts/bench_flash_variants.py``. Each variant of
``gmf_tpu_torch.ops.flash_variants`` (v0-v6: how the compat term is
formed, or not at all) runs ``--layers`` layers of x -> attn(x, x, x) over
``--batch`` pairs of ``--num-corr`` correspondences, D=128, sigma_d 0.10,
scale 1/sqrt(D), bf16 q drawn from ``np.random.RandomState(0)`` and
keypoints uniform in a 3 m cube, as the script draws them. One warm run,
then ``--iters`` timed runs. One line per variant, in the script's format:

    v0 bq=   64 bk=   32:  ms/batch (pairs/s fwd-only)  max|Δ| vs v0 = ...

``bq``/``bk`` are the port's one tile (the script's tile sweep has no
counterpart); max|Δ| is the largest difference of the stack's output from
v0's (v1 has none: it drops compat); v4 and v5 add the time of their cache
precompute, which runs once before the stack; each line ends with the
peak device memory of its stack (the cache included). Then the same stack
through
``torch.nn.functional.scaled_dot_product_attention`` (one head, no mask,
the backend it chooses): the library's time for v1's function, and its
difference from v1 after the stack and after one layer (the stack
amplifies the two softmaxes' different bf16 roundings from layer to
layer). The last line is one JSON object with every number.

On the card the times are CUDA-event means. With ``--device cpu`` the
variants run their plain versions and the times are host-clock means that
say nothing of the card. Any failure ends the run with an error.
"""

from __future__ import annotations

import argparse
import functools
import json
import subprocess
import time

import numpy as np
import torch

from gmf_tpu_torch.ops.flash_variants import (CACHE_DTYPES, TILE, VARIANTS,
                                              flash_variant)
from gmf_tpu_torch.ops.fused_attention import (build_compat_cache,
                                               compat_flash_attention)
from gmf_tpu_torch.utils.device import resolve_device

D = 128
SIGMA_D = 0.10


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--num-corr", type=int, default=5000)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    return ap.parse_args(argv)


def make_inputs(batch, num_corr, device):
    """q [B, N, D] bf16 and the keypoints [B, N, 3] f32, as the script
    makes them."""
    rng = np.random.RandomState(0)
    q = torch.tensor(rng.randn(batch, num_corr, D)).to(torch.bfloat16)
    src = torch.tensor(rng.rand(batch, num_corr, 3) * 3.0,
                       dtype=torch.float32)
    tgt = torch.tensor(rng.rand(batch, num_corr, 3) * 3.0,
                       dtype=torch.float32)
    return q.to(device), src.to(device), tgt.to(device)


def timed(fn, iters, device):
    """One warm call, then the mean ms of ``iters`` calls (CUDA events on
    the card, the host clock on the CPU) and the last call's result. Each
    call's result is dropped before the next call, whose output then
    takes its memory: a 6.4 GB cache is not allocated anew in the timed
    loop."""
    out = fn()
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        del out
        out = fn()
    if not cuda:
        return out, 1e3 * (time.perf_counter() - t0) / iters
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end) / iters


def stack(layer, x, layers):
    for _ in range(layers):
        x = layer(x)
    return x


def variant_layer(x, variant, src, tgt):
    return flash_variant(x, x, x, src, tgt, variant=variant, sigma_d=SIGMA_D)


def cached_layer(x, cache):
    """v4 and v5: the cached kernel on a precomputed cache."""
    return compat_flash_attention(x, x, x, None, None, compat=cache)


def sdpa_layer(x):
    h = x.unsqueeze(1)  # one head
    return torch.nn.functional.scaled_dot_product_attention(h, h, h)[:, 0]


def sdpa_backend(x):
    """The backend ``scaled_dot_product_attention`` dispatches these
    inputs to (its own choice, nothing forced)."""
    from torch.nn.attention import SDPBackend

    h = x.unsqueeze(1)
    return SDPBackend(torch._fused_sdp_choice(h, h, h)).name


def _max_diff(a, b):
    return (a.float() - b.float()).abs().max().item()


def run(args):
    """Run the benchmark; print its lines and return the JSON result."""
    device = resolve_device(args.device)
    cuda = device.type == "cuda"
    B, N = args.batch, args.num_corr
    result = dict(batch=B, num_corr=N, d=D, layers=args.layers,
                  iters=args.iters, sigma_d=SIGMA_D, tile=list(TILE),
                  device=device.type,
                  timer="cuda events" if cuda else "host clock")
    if cuda:
        result["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
        result["kind"] = torch.cuda.get_device_name(0)
        print(result["card"], flush=True)
    q, src, tgt = make_inputs(B, N, device)
    outputs, rows = {}, {}
    for variant in VARIANTS:
        row = {}
        if variant in CACHE_DTYPES:
            cache, row["precompute_ms"] = timed(
                lambda: build_compat_cache(src, tgt, SIGMA_D,
                                           CACHE_DTYPES[variant]),
                args.iters, device)
            layer = functools.partial(cached_layer, cache=cache)
        else:
            cache = None
            layer = functools.partial(variant_layer, variant=variant,
                                      src=src, tgt=tgt)

        if cuda:
            torch.cuda.reset_peak_memory_stats()
        out, ms = timed(lambda: stack(layer, q, args.layers), args.iters,
                        device)
        row.update(_stack_row(ms, B, args.layers))
        row["max_abs_diff_vs_v0"] = (
            None if variant == "v1" else
            _max_diff(out, outputs.get("v0", out)))
        row["peak_memory_bytes"] = (torch.cuda.max_memory_allocated()
                                    if cuda else None)
        rows[variant] = row
        if variant in ("v0", "v1"):
            outputs[variant] = out  # the references of the differences
        del layer, cache, out
        print(_line(variant, row), flush=True)
    result["variants"] = rows

    if cuda:
        torch.cuda.reset_peak_memory_stats()
    out, ms = timed(lambda: stack(sdpa_layer, q, args.layers), args.iters,
                    device)
    sdpa = dict(_stack_row(ms, B, args.layers), backend=sdpa_backend(q),
                max_abs_diff_vs_v1=_max_diff(out, outputs["v1"]),
                peak_memory_bytes=(torch.cuda.max_memory_allocated()
                                   if cuda else None))
    one_v1 = variant_layer(q, "v1", src, tgt)
    sdpa["one_layer_max_abs_diff_vs_v1"] = _max_diff(sdpa_layer(q), one_v1)
    sdpa["one_layer_v1_max_abs_out"] = one_v1.float().abs().max().item()
    result["sdpa"] = sdpa
    print(f"sdpa ({sdpa['backend']}): {sdpa['ms_per_stack']:8.1f} ms/batch "
          f"({sdpa['pairs_per_s']:7.1f} pairs/s fwd-only)  max|Δ| vs v1 = "
          f"{sdpa['max_abs_diff_vs_v1']:.2e} (one layer: "
          f"{sdpa['one_layer_max_abs_diff_vs_v1']:.2e})  "
          f"{_peak(sdpa['peak_memory_bytes'])}", flush=True)
    print(json.dumps(result), flush=True)
    return result


def _stack_row(ms, batch, layers):
    return dict(ms_per_stack=ms, ms_per_layer=ms / layers,
                pairs_per_s=1e3 * batch / ms)


def _line(variant, row):
    drift = ("" if row["max_abs_diff_vs_v0"] is None else
             f"  max|Δ| vs v0 = {row['max_abs_diff_vs_v0']:.2e}")
    pre = ("" if "precompute_ms" not in row else
           f"  (+precompute {row['precompute_ms']:.1f} ms)")
    return (f"{variant} bq={TILE[0]:5d} bk={TILE[1]:5d}: "
            f"{row['ms_per_stack']:8.1f} ms/batch "
            f"({row['pairs_per_s']:7.1f} pairs/s fwd-only){drift}{pre}  "
            f"{_peak(row['peak_memory_bytes'])}")


def _peak(nbytes):
    return ("peak memory not measured (cpu)" if nbytes is None
            else f"peak {nbytes} bytes")


def main(argv=None):
    with torch.inference_mode():
        return run(parse_args(argv))


if __name__ == "__main__":
    main()
