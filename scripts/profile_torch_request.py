"""Trace registrar requests of gmf_tpu_torch's main path on the card.

    python scripts/profile_torch_request.py [--pairs 64] [--num-corr 5000]
        [--compat-cache int8] [--seed-solver auto] [--out DIR]

Serves chip_smoke.py's full-width registrar in the given mode (its first
request of ``--pairs`` pairs of ``--num-corr`` correspondences; the
defaults are the main path) for two
warm-up requests, then REPS requests without the
profiler, then REPS requests each under its own torch.profiler session.
Prints the device time per kernel name (top 25, last traced request), and
one JSON line with the unprofiled and profiled wall times, the device-busy
time of each traced request (summed kernel time; kernels of one stream do
not overlap), the busy share against the mean unprofiled wall time, and
the host syncs of the last traced request (``cudaStreamSynchronize`` and
``cudaMemcpy*`` calls, which block the host) and the peak device memory
of an unprofiled request. With --out, the last Chrome trace is written
there.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

REPS = 3


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--pairs", type=int, default=64,
                    help="pairs per request")
    ap.add_argument("--num-corr", type=int, default=5000,
                    help="correspondences per pair (the one bucket)")
    ap.add_argument("--compat-cache", default="int8",
                    choices=("auto", "off", "f32", "bf16", "int8"))
    ap.add_argument("--seed-solver", default="auto",
                    choices=("auto", "xla", "fused"))
    ap.add_argument("--out", help="directory for trace.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")

    from chip_smoke import make_registrar, make_requests
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    reg = make_registrar(torch.device("cuda"),
                         compat_cache=args.compat_cache,
                         seed_solver=args.seed_solver,
                         num_corr=args.num_corr)
    req = make_requests(args.pairs, args.num_corr)[0]

    cache, build = reg.model._build_compat_cache(
        *(torch.zeros(args.pairs, args.num_corr, 3, device="cuda"),) * 2)
    resolved = ("int8" if build else "off" if cache is None
                else str(cache.dtype))
    del cache

    def timed():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reg.register_batch(req)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0)

    for _ in range(2):
        timed()
    torch.cuda.reset_peak_memory_stats()
    wall = [timed() for _ in range(REPS)]
    peak = torch.cuda.max_memory_allocated()
    wall_prof, busy = [], []
    for _ in range(REPS):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall_prof.append(timed())
        events = prof.key_averages()
        # device-side entries only: the aten ops that launched them carry
        # the same time again
        rows = sorted(((e.self_device_time_total, e.count, e.key)
                       for e in events if e.device_type == DeviceType.CUDA),
                      reverse=True)
        busy.append(sum(r[0] for r in rows) / 1e3)

    syncs = {e.key: e.count for e in events
             if e.key.startswith(("cudaStreamSynchronize", "cudaMemcpy",
                                  "cudaDeviceSynchronize"))}
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    print(f"{'device ms':>10} {'calls':>6}  name")
    for us, n, key in rows[:25]:
        print(f"{us / 1e3:10.3f} {n:6d}  {key[:90]}")
    summary = {"pairs": args.pairs, "num_corr": args.num_corr,
               "compat_cache": args.compat_cache,
               "cache_resolved": resolved,
               "seed_solver": args.seed_solver,
               "peak_memory_bytes": peak, "wall_ms": wall,
               "wall_ms_profiled": wall_prof,
               "device_busy_ms": busy,
               "device_busy_share": float(np.mean(busy) / np.mean(wall)),
               "host_sync_calls": syncs}
    print(json.dumps(summary))
    if args.out:
        Path(args.out).mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(Path(args.out) / "trace.json"))


if __name__ == "__main__":
    main()
