"""Trace registrar requests or training steps of gmf_tpu_torch on the card.

    python scripts/profile_torch_request.py [--pairs 64] [--num-corr 5000]
        [--compat-cache int8] [--seed-solver auto] [--no-fused] [--out DIR]
    python scripts/profile_torch_request.py --train [--pairs 16]
        [--num-corr 1000] [--compat-cache auto] [--no-fused] [--out DIR]

Serves chip_smoke.py's full-width registrar in the given mode (its first
request of ``--pairs`` pairs of ``--num-corr`` correspondences; the
defaults are the serving main path), or with ``--train`` takes train
steps of chip_smoke.py's full-width f32 trainer on one synthetic batch
(the defaults are the training main path: 16 pairs of 1000, the f32
cache). ``--no-fused`` takes the dense attention (``fused_attention=
False``, the reference's default) in place of the attention kernels.
Two warm-up requests or steps, then REPS without the profiler,
then REPS each under its own torch.profiler session.
Prints the device time per kernel name (top 25, last traced request), and
one JSON line with the unprofiled and profiled wall times, the device-busy
time of each traced request (summed kernel time; kernels of one stream do
not overlap), the busy share against the mean unprofiled wall time, and
the host syncs of the last traced request (``cudaStreamSynchronize`` and
``cudaMemcpy*`` calls, which block the host), its count of device
operations and of kernel-launch calls, the host ops with the most CPU
time of their own, the device time of the port's attention kernels
(forward and backward) and its share of the busy time, and the peak
device memory of an unprofiled request. With --out,
the last Chrome trace is written there.
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
    ap.add_argument("--train", action="store_true",
                    help="profile train steps instead of requests")
    ap.add_argument("--pairs", type=int, default=None,
                    help="pairs per request or step (64; --train 16)")
    ap.add_argument("--num-corr", type=int, default=None,
                    help="correspondences per pair (5000; --train 1000)")
    ap.add_argument("--compat-cache", default=None,
                    choices=("auto", "off", "f32", "bf16", "int8"),
                    help="int8; --train auto")
    ap.add_argument("--seed-solver", default="auto",
                    choices=("auto", "xla", "fused"))
    ap.add_argument("--no-fused", action="store_true",
                    help="the dense attention (fused_attention=False)")
    ap.add_argument("--out", help="directory for trace.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")

    import chip_smoke
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda")
    if args.train:
        args.pairs = args.pairs or chip_smoke.B_TRAIN
        args.num_corr = args.num_corr or chip_smoke.N_TRAIN
        args.compat_cache = args.compat_cache or "auto"
        trainer = chip_smoke.make_trainer(dev, args.compat_cache,
                                          batch_size=args.pairs,
                                          num_corr=args.num_corr,
                                          fused_attention=not args.no_fused)
        batch = next(iter(trainer.train_loader))
        model = trainer.model

        def work():
            trainer.train_step(batch, epoch=1)
    else:
        args.pairs = args.pairs or 64
        args.num_corr = args.num_corr or 5000
        args.compat_cache = args.compat_cache or "int8"
        reg = chip_smoke.make_registrar(dev, compat_cache=args.compat_cache,
                                        seed_solver=args.seed_solver,
                                        num_corr=args.num_corr,
                                        fused_attention=not args.no_fused)
        req = chip_smoke.make_requests(args.pairs, args.num_corr)[0]
        model = reg.model

        def work():
            reg.register_batch(req)

    with torch.no_grad():
        cache, build = model._build_compat_cache(
            *(torch.zeros(args.pairs, args.num_corr, 3, device=dev),) * 2,
            testing=not args.train)
    resolved = ("dense" if args.no_fused else "int8" if build
                else "off" if cache is None else str(cache.dtype))
    del cache

    def timed():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        work()
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
        # the same time again, and so do user annotations such as
        # Optimizer.step, whose span on the device covers their kernels
        rows = sorted(((e.self_device_time_total, e.count, e.key)
                       for e in events if e.device_type == DeviceType.CUDA
                       and not getattr(e, "is_user_annotation", False)),
                      reverse=True)
        busy.append(sum(r[0] for r in rows) / 1e3)

    syncs = {e.key: e.count for e in events
             if e.key.startswith(("cudaStreamSynchronize", "cudaMemcpy",
                                  "cudaDeviceSynchronize"))}
    launch_calls = sum(e.count for e in events
                       if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                    "cudaLaunchKernelExC", "cuLaunchKernelEx"))
    # host-side ops by their own CPU time (children excluded)
    host = sorted(((e.self_cpu_time_total, e.count, e.key) for e in events
                   if e.device_type == DeviceType.CPU), reverse=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    print(f"{'device ms':>10} {'calls':>6}  name")
    for us, n, key in rows[:25]:
        print(f"{us / 1e3:10.3f} {n:6d}  {key[:90]}")
    attention = sum(r[0] for r in rows if "compat_flash" in r[2]) / 1e3
    summary = {"mode": "train" if args.train else "serve",
               "pairs": args.pairs, "num_corr": args.num_corr,
               "compat_cache": args.compat_cache,
               "cache_resolved": resolved,
               "seed_solver": args.seed_solver,
               "peak_memory_bytes": peak, "wall_ms": wall,
               "wall_ms_profiled": wall_prof,
               "device_busy_ms": busy,
               "device_busy_share": float(np.mean(busy) / np.mean(wall)),
               "attention_kernels_ms": attention,
               "attention_share_of_busy": attention / busy[-1],
               "device_ops": sum(r[1] for r in rows),
               "kernel_launch_calls": launch_calls,
               "host_self_ms_top": [[key, us / 1e3, n]
                                    for us, n, key in host[:12]],
               "host_sync_calls": syncs}
    print(json.dumps(summary))
    if args.out:
        Path(args.out).mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(Path(args.out) / "trace.json"))


if __name__ == "__main__":
    main()
