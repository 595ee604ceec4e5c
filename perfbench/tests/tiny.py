"""A tiny copy of the benchmark for CPU tests: the perfbench tree copied
under a temporary root, with a cell of its own added as new files (a
2-layer, 32-channel configuration, 3 pairs of up to 300 rows a request)
and its entries in a copy of BENCHMARK.json. Nothing of the repository's
own files is edited: that is how a later change adds a cell."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
CELL = "tiny_eval"


# cells whose files are in perfbench/ but that BENCHMARK.json leaves out
# (PERF.md, Open questions): their configuration and traffic
OUT_OF_BENCHMARK = {
    "pointdsc_3dmatch_train_b16": dict(config="pointdsc_gmf_3dmatch",
                                       traffic="3dmatch_train_b16"),
}


def tiny_tree(tmp: Path, base_cell="pointdsc_3dmatch_eval_b64") -> Path:
    root = Path(tmp) / "checkout"
    shutil.copytree(REPO / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == base_cell),
                 None) or OUT_OF_BENCHMARK[base_cell]
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    cfg = json.loads((REPO / conf["file"]).read_text())
    cfg["name"] = "tiny_config"
    cfg["model"].update(num_layers=2, num_channels=32, k=8)
    (root / "perfbench/configs/tiny_config.json").write_text(json.dumps(cfg))
    mix = json.loads((REPO / "perfbench/traffic/mixes" /
                      f"{entry['traffic']}.json").read_text())
    bucket = 300 if mix["bucket"] < 12000 else 400
    lo, hi = mix["valid"]
    mix.update(pairs_per_request=3, pool_requests=4, bucket=bucket,
               valid=[bucket, bucket] if lo == hi else [bucket - 100, bucket],
               image_hw=[24, 32])
    (root / "perfbench/traffic/mixes/tiny_mix.json").write_text(
        json.dumps(mix))
    cell = json.loads((REPO / "perfbench/workloads" /
                       f"{base_cell}.json").read_text())
    if "check" in cell:
        cell["warmup_requests"] = 1
        cell["check"].update(sample_requests=1, sample_within=0.0,
                             pairs_per_block=3)
    (root / f"perfbench/workloads/{CELL}.json").write_text(json.dumps(cell))
    bench["configs"].append(dict(name="tiny_config", source="test",
                                 file="perfbench/configs/tiny_config.json",
                                 reduced=["num_layers", "k"], why="test"))
    bench["workloads"].append(dict(name=CELL, config="tiny_config",
                                   traffic="tiny_mix", chips=1, why="test"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if base_cell in m.get("workloads", []):
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def run_tiny(root: Path, capsys, seconds=1.0, seed=3000000001, trace=0):
    """Run the tiny cell on the CPU through the harness (the look for a
    card skipped): the result line's object."""
    import time

    from perfbench import harness

    rc = harness.main(["--workload", CELL, "--seed", str(seed),
                       "--seconds", str(seconds), "--trace", str(trace)],
                      time.perf_counter(), root=root, require_cuda=False)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])
