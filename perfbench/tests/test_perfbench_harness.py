"""The harness finds each piece by name, a cell added as new files runs
without an edit elsewhere, names and units keep to the benchmark's
characters, and nothing of the benchmark loads JAX, flax or gmf_tpu (nor
the reference anything of the program)."""

from __future__ import annotations

import ast
import json
import re
import sys
import types
from pathlib import Path

import pytest

from perfbench import harness
from perfbench.tests.tiny import CELL, REPO, run_tiny, tiny_tree

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_paths():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs",
                           "workloads", "end_to_end", "per_layer"]
    assert BENCH["paths"] == ["perfbench"]
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert (REPO / "BENCHMARK.json").stat().st_size <= 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_piece_is_found_by_name(cell):
    c = harness.Cell(REPO, cell)
    assert callable(c.driver.run)
    assert c.config["name"] == c.entry["config"]
    assert set(c.cell["limits"]) and c.traffic["bucket"] > 0
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert callable(c.reader(m).read)
        assert m["moves"] in e2e


def test_names_and_units():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            assert NAME.match(entry["name"]), entry["name"]
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for c in BENCH["configs"]:
        for key in c["reduced"]:
            assert NAME.match(key)
        assert (REPO / c["file"]).is_file()
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({e["name"] for e in BENCH[group]}) == len(BENCH[group])


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            yield node.module.split(".")[0]


def test_no_module_loads_jax_or_gmf_tpu():
    for path in (REPO / "perfbench").rglob("*.py"):
        found = set(_imports(path)) & {"jax", "jaxlib", "flax", "gmf_tpu"}
        assert not found, f"{path} imports {found}"


def test_reference_imports_nothing_of_the_program():
    for path in (REPO / "perfbench" / "reference").rglob("*.py"):
        found = set(_imports(path)) & {"gmf_tpu_torch", "gmf_tpu", "jax"}
        assert not found, f"{path} imports {found}"


def test_new_cell_from_new_files_runs(tmp_path, capsys):
    root = tiny_tree(tmp_path)
    line = run_tiny(root, capsys)
    assert list(line)[-1] == "checks"
    assert line["correct"], line["checks"]
    assert {"pairs_per_s", "setup_s"} <= set(line["metrics"])
    assert line["device"]["count"] == 1


def test_no_card_no_result(tmp_path, capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is here")
    root = tiny_tree(tmp_path)
    rc = harness.main(["--workload", CELL, "--seed", "1", "--seconds", "1"],
                      0.0, root=root)
    assert rc != 0 and capsys.readouterr().out == ""


def test_jax_in_the_process_refuses_the_result(tmp_path, capsys,
                                               monkeypatch):
    root = tiny_tree(tmp_path)
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    rc = harness.main(["--workload", CELL, "--seed", "1", "--seconds",
                       "0.5"], 0.0, root=root, require_cuda=False)
    assert rc != 0 and capsys.readouterr().out == ""


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_sampled_requests_spread_over_the_window(cell):
    """The check's sampled requests: distinct entries of a pool, at points
    drawn over the window, other ones for other seeds."""
    from perfbench.drivers.eval_batch import sample_plan

    c = harness.Cell(REPO, cell)
    check = c.cell["check"]
    keys = c.traffic["pool_requests"]
    plans = [sample_plan(seed, check, keys)
             for seed in range(3000000000, 3000000040)]
    for plan in plans:
        picked = [k for _, k in plan]
        assert len(set(picked)) == len(picked) == min(
            check["sample_requests"], keys)
        assert all(0 <= s < check["sample_within"] for s, _ in plan)
    shares = [s for plan in plans for s, _ in plan]
    assert max(shares) > 0.5 * check["sample_within"]
    assert len({tuple(k for _, k in p) for p in plans}) > 1
