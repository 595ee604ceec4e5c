"""The service's knee: the highest Poisson rate it sustains.

    python3 perfbench/sweep.py --workload <service cell> --seed N
        --rates 60,80,100 [--seconds 15]

One run of the cell a rate, in one process, each with the cell's own
checks; one JSON line a rate: latency p50 and p95, the completed pairs a
second, the mean flush, and the backlog's growth (the median latency of
the last fifth of the requests over the first fifth's: about 1 when the
queue does not grow). Used once, when the cell is defined, to fix its
rate at about four fifths of the knee.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
os.environ["USE_FLAX"] = "0"

import numpy as np  # noqa: E402

from perfbench import harness  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=15.0)
    args = ap.parse_args()
    cell = harness.Cell(harness.ROOT, args.workload)
    device = harness.open_device(cell.entry["chips"])
    if device is None:
        sys.exit("needs a CUDA device")
    for rate in (float(r) for r in args.rates.split(",")):
        cell.cell["rate"] = rate
        run_args = harness.parse(["--workload", args.workload, "--seed",
                                  str(args.seed), "--seconds",
                                  str(args.seconds)])
        ctx, out = harness.run_cell(cell, run_args, time.perf_counter(),
                                    device)
        lat = np.asarray(out.trace.counts["latency_ms"])
        fifth = max(1, len(lat) // 5)
        row = dict(rate=rate, requests=out.attempted, failed=out.failed,
                   p50_ms=float(np.percentile(lat, 50)),
                   p95_ms=out.e2e["latency_p95_ms"],
                   completed_per_s=out.trace.counts["completed_per_s"],
                   flush_pairs_mean=out.trace.counts["pairs"] /
                   max(1, out.trace.counts["flushes"]),
                   backlog_growth=float(np.median(lat[-fifth:]) /
                                        np.median(lat[:fifth])),
                   late_s=out.trace.counts["generator_late_s"],
                   correct=all(c["ok"] for c in out.checks),
                   checks={c["name"]: c["value"] for c in out.checks})
        print(json.dumps(row), flush=True)
        ctx.free()


if __name__ == "__main__":
    main()
