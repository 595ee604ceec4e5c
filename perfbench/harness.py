"""The benchmark's harness: finds a cell's pieces by name, runs its driver,
and prints the result.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Everything is found by the names in ``BENCHMARK.json``:

- the cell: ``perfbench/workloads/<cell>.json`` (its driver, warm-up,
  sample sizes and the limits of its checks);
- its configuration: the ``file`` of the configuration it names;
- its traffic: ``perfbench/traffic/mixes/<traffic>.json``;
- its driver: ``perfbench/drivers/<driver>.py``, whose ``run(ctx)``
  returns an ``Outcome``;
- each per-layer metric: ``perfbench/metrics/<metric>.py``, whose
  ``read(trace)`` returns a number, or None when it finds nothing to read.

A new cell, configuration, traffic mix or metric is a new file and its
entry in ``BENCHMARK.json``.

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each compared number beside its
limit); the checks are also the last lines of standard error. A run
without the cards the cell asks for, or in whose process JAX or
``gmf_tpu`` was loaded, prints no result and exits with another code
than 0.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "gmf_tpu")


@dataclasses.dataclass
class Outcome:
    attempted: int
    failed: int
    e2e: Dict[str, float]
    checks: List[dict]
    trace: object
    memory_peak_bytes: int


def check_value(name, value, limit):
    """One compared number: it passes when it is at most its limit."""
    ok = isinstance(value, (int, float)) and math.isfinite(value) \
        and value <= limit
    return dict(name=name, value=value, limit=limit, ok=bool(ok))


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Cell:
    """A cell's pieces, found by name under ``root``."""

    def __init__(self, root: Path, name: str):
        self.root = Path(root)
        self.bench = load_json(self.root / "BENCHMARK.json")
        entries = {w["name"]: w for w in self.bench["workloads"]}
        if name not in entries:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        self.entry = entries[name]
        self.name = name
        here = self.root / "perfbench"
        self.cell = load_json(here / "workloads" / f"{name}.json")
        configs = {c["name"]: c for c in self.bench["configs"]}
        self.config = load_json(self.root / configs[self.entry["config"]][
            "file"])
        self.traffic = load_json(here / "traffic" / "mixes" /
                                 f"{self.entry['traffic']}.json")
        self.driver = load_module(
            here / "drivers" / f"{self.cell['driver']}.py",
            f"perfbench_driver_{self.cell['driver']}")

    def _applies(self, metric):
        return self.name in metric.get("workloads", [self.name])

    @property
    def end_to_end(self):
        return [m for m in self.bench["end_to_end"] if self._applies(m)]

    @property
    def per_layer(self):
        return [m for m in self.bench["per_layer"] if self._applies(m)]

    def reader(self, metric):
        return load_module(self.root / "perfbench" / "metrics" /
                           f"{metric['name']}.py",
                           "perfbench_metric_" + metric["name"].replace(
                               ".", "_"))


class Context:
    """What a driver gets: the cell's pieces, the run's arguments, the
    device, and the set-up clock."""

    def __init__(self, cell: Cell, args, t0: float, device):
        self.cell = cell.cell
        self.config = cell.config
        self.traffic = cell.traffic
        self.seed = args.seed
        self.seconds = args.seconds
        self.trace = bool(args.trace)
        self.device = device
        self.t0 = t0
        self.setup_s: Optional[float] = None
        self.kept = None  # a tool sets a list: what the check judged
        self.notes = {}  # what a tool reads beside the checks
        self.phases = []  # (set-up phase, seconds since the last)

    def phase(self, name):
        """Mark the end of a set-up phase (printed to standard error)."""
        at = time.perf_counter() - self.t0
        done = sum(s for _, s in self.phases)
        self.phases.append((name, at - done))

    def window_seconds(self):
        """The window: ``--seconds``, cut to the cell's ``trace_seconds``
        in a traced run."""
        if self.trace:
            return min(self.seconds, self.cell["trace_seconds"])
        return self.seconds

    def sync(self):
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def setup_done(self):
        """Set-up ends here: the window starts."""
        self.sync()
        self.phase("warm-up")
        import torch

        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        self.setup_s = time.perf_counter() - self.t0

    def memory_peak(self):
        import torch

        if self.device.type != "cuda":
            return 0
        self.sync()
        return int(torch.cuda.max_memory_allocated())

    def free(self):
        import gc

        import torch

        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def parse(argv):
    ap = argparse.ArgumentParser(description="Run one benchmark cell.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def result(cell: Cell, ctx: Context, out: Outcome, device_info):
    """The result line's object, ``checks`` last."""
    correct = out.failed == 0 and all(c["ok"] for c in out.checks)
    metrics = {}
    if ctx.trace:
        trace = out.trace
        for m in cell.per_layer:
            value = cell.reader(m).read(trace)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info = dict(device_info, busy_s=trace.busy_s,
                           window_s=trace.window_s)
    else:
        values = dict(out.e2e, setup_s=ctx.setup_s)
        for m in cell.end_to_end:
            if values.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    line = {"correct": bool(correct), "attempted": out.attempted,
            "failed": out.failed, "metrics": metrics,
            "device": device_info}
    if ctx.trace:
        line["breakdown"] = {"device_ops": out.trace.device_ops,
                             "idle_gaps": out.trace.idle_gaps}
    line["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                      for c in out.checks}
    return line


def open_device(chips: int, require_cuda: bool = True):
    """The card the run uses (None when the cards the cell asks for are
    not there); without ``require_cuda``, the card or the CPU."""
    import torch

    if require_cuda:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < chips:
            return None
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    else:
        device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    # the configurations state f32 with TF32 off, for the program and the
    # reference alike
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(min(torch.get_num_threads(), 4))
    return device


def run_cell(cell: Cell, args, t0: float, device):
    """Run the cell's driver: (context, outcome)."""
    ctx = Context(cell, args, t0, device)
    return ctx, cell.driver.run(ctx)


def main(argv, t0: float, root: Path = ROOT, require_cuda: bool = True):
    args = parse(argv)
    cell = Cell(root, args.workload)
    import torch

    chips = cell.entry["chips"]
    device = open_device(chips, require_cuda)
    if device is None:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"needs {chips} CUDA device(s); found {found}", file=sys.stderr)
        return 2
    ctx, out = run_cell(cell, args, t0, device)
    found = forbidden_modules()
    if found:
        print(f"the run loaded {', '.join(found)}: the benchmark measures "
              "the PyTorch port alone", file=sys.stderr)
        return 3
    if ctx.trace and device.type == "cuda" and not out.trace.device_seen:
        print("the traced window saw no device operation", file=sys.stderr)
        return 4
    device_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "kind": (torch.cuda.get_device_name(device)
                            if device.type == "cuda" else "cpu"),
                   "count": chips,
                   "memory_peak_bytes": out.memory_peak_bytes}
    line = result(cell, ctx, out, device_info)
    print("set-up: " + ", ".join(f"{n} {s:.2f} s" for n, s in ctx.phases),
          file=sys.stderr)
    for c in out.checks:
        print(f"check {c['name']}: {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['ok'] else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
