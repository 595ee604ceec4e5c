"""Package rules of gmf_tpu_torch: no JAX anywhere, the card by default."""

import ast
import functools
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import gmf_tpu_torch
from gmf_tpu_torch.data.synthetic import make_correspondence_problem
from gmf_tpu_torch.eval.registration import PointDSCRegistrar
from gmf_tpu_torch.models import PointDSC
from gmf_tpu_torch.ops import (flash_variants, fused_attention,
                               fused_seed_solver)
from gmf_tpu_torch.tools import bench_flash_variants

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "gmf_tpu")


def test_importing_the_port_loads_no_jax():
    """Every gmf_tpu_torch module, and chip_smoke.py, imported in a fresh
    interpreter, leaves no jax/flax/gmf_tpu module behind."""
    code = (
        "import importlib, pkgutil, sys, runpy\n"
        "import gmf_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(\n"
        "    gmf_tpu_torch.__path__, 'gmf_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "runpy.run_path('chip_smoke.py', run_name='chip_smoke')\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "print(len(mods), bad)\n"
        "sys.exit(1 if bad or len(mods) < 16 else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_no_jax_import_statements():
    files = sorted((ROOT / "gmf_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "scripts/profile_torch_request.py",
        ROOT / "scripts/check_train_faults.py",
        ROOT / "scripts/check_dgr_card_vs_cpu.py"]
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN, (f, n)


def test_entry_points_default_to_cuda():
    """Without CUDA the entry points raise unless device="cpu"; with it,
    the default is the card."""
    kw = dict(num_layers=1, num_channels=16, k=5)
    if torch.cuda.is_available():
        assert PointDSC(**kw).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PointDSC(**kw)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PointDSC(device="cuda", **kw)
    model = PointDSC(device="cpu", **kw)
    assert model.device.type == "cpu"
    prob = make_correspondence_problem(np.random.RandomState(0), num_corr=60,
                                       image_hw=(16, 16))
    trans, labels = PointDSCRegistrar(model, buckets=(64,))(
        {k: v[0] for k, v in prob.items()})
    assert trans.shape == (4, 4) and labels.shape == (60,)
    assert np.isfinite(trans).all()


def test_bench_entry_point_defaults_to_cuda():
    """The variant microbenchmark runs on the card unless asked for the
    CPU, and without CUDA it raises instead of falling back."""
    assert bench_flash_variants.parse_args([]).device == "cuda"
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench_flash_variants.main(["--num-corr", "8", "--batch", "1",
                                   "--layers", "1", "--iters", "1"])


def test_no_jax_checks_cover_the_tools():
    """tools/ is inside the checks above: the glob of
    test_no_jax_import_statements and the package walk of
    test_importing_the_port_loads_no_jax both reach it."""
    assert (ROOT / "gmf_tpu_torch/tools/bench_flash_variants.py") in set(
        (ROOT / "gmf_tpu_torch").rglob("*.py"))
    assert "gmf_tpu_torch.tools.bench_flash_variants" in {
        m.name for m in pkgutil.walk_packages(gmf_tpu_torch.__path__,
                                              "gmf_tpu_torch.")}


# the model zoo, the converters and the classical baselines: every module
# (the two command lines and the checkpoint tool among them) is reached by
# the package walk and the import-statement glob above
ZOO_AND_BASELINES = (
    "sparse/simpleunet.py", "sparse/pyramidnet.py", "models/blocks.py",
    "models/oanet.py", "models/registry.py", "utils/convert_torch.py",
    "utils/convert_minkowski.py", "tools/print_checkpoint.py",
    "utils/max_clique.py", "utils/gcransac.py", "utils/native.py",
    "eval/baselines.py", "eval/baseline_eval.py")


@pytest.mark.parametrize("path", ZOO_AND_BASELINES)
def test_no_jax_checks_cover_the_zoo_and_baselines(path):
    assert (ROOT / "gmf_tpu_torch" / path) in set(
        (ROOT / "gmf_tpu_torch").rglob("*.py"))
    name = "gmf_tpu_torch." + path[:-3].replace("/", ".")
    assert name in {m.name for m in pkgutil.walk_packages(
        gmf_tpu_torch.__path__, "gmf_tpu_torch.")}


# the reconstruction apps, the tools and the utilities of ROADMAP item 6's
# first two entries, likewise
APPS_AND_TOOLS = (
    "apps/__init__.py", "apps/multiway.py", "apps/tsdf.py",
    "apps/make_fragments.py", "apps/multiway_cli.py", "data/redwood.py",
    "data/camera.py", "tools/analyze_stats.py", "tools/build_kitti_pairs.py",
    "tools/numerics_study.py", "tools/precompute_descriptors.py",
    "utils/logging_utils.py", "utils/profiling.py", "utils/timer.py")


@functools.cache
def _walked():
    return {m.name for m in pkgutil.walk_packages(gmf_tpu_torch.__path__,
                                                  "gmf_tpu_torch.")}


def _reached(path: str) -> bool:
    """Whether gmf_tpu_torch/<path> is in the import-statement glob and
    the package walk of the no-JAX checks above."""
    if (ROOT / "gmf_tpu_torch" / path) not in set(
            (ROOT / "gmf_tpu_torch").rglob("*.py")):
        return False
    name = "gmf_tpu_torch." + path[:-3].replace("/", ".")
    if name.endswith(".__init__"):
        name = name[:-len(".__init__")]
    return name == "gmf_tpu_torch" or name in _walked()


@pytest.mark.parametrize("path", APPS_AND_TOOLS)
def test_no_jax_checks_cover_the_apps_and_tools(path):
    assert _reached(path)
    assert (ROOT / "gmf_tpu" / path).exists()


# gmf_tpu/parallel/, the last module slice, likewise
PARALLEL = ("parallel/__init__.py", "parallel/mesh.py",
            "parallel/ring_attention.py")


@pytest.mark.parametrize("path", PARALLEL)
def test_no_jax_checks_cover_parallel(path):
    assert _reached(path)
    assert (ROOT / "gmf_tpu" / path).exists()


GMF_TPU_MODULES = sorted(str(p.relative_to(ROOT / "gmf_tpu"))
                         for p in (ROOT / "gmf_tpu").rglob("*.py"))


@pytest.mark.parametrize("path", GMF_TPU_MODULES)
def test_every_gmf_tpu_module_has_its_counterpart(path):
    """Module parity, the end of the port's first queue: every module of
    gmf_tpu has its counterpart at the same path in gmf_tpu_torch, inside
    the no-JAX checks."""
    assert _reached(path), path


def test_wrappers_take_plain_version_only_on_cpu():
    x = torch.zeros(1, 4, 32, device="meta")
    kp = torch.zeros(1, 4, 3, device="meta")
    cache = torch.zeros(1, 4, 16, dtype=torch.int8, device="meta")
    knn = torch.zeros(1, 2, 4, 3, device="meta")
    calls = [
        lambda: fused_attention.compat_flash_attention(x, x, x, kp, kp),
        lambda: fused_attention.compat_flash_attention(x, x, x, None, None,
                                                       compat=cache),
        lambda: fused_attention.compat_flash_attention_build(x, x, x, kp, kp),
        lambda: fused_attention.build_compat_cache(kp, kp, 0.1, torch.int8),
        lambda: fused_seed_solver.fused_seed_weights(
            torch.zeros(1, 2, 4, 32, device="meta"), knn, knn, 1.0, 0.1),
        *(functools.partial(flash_variants.flash_variant, x, x, x, kp, kp,
                            variant=v) for v in flash_variants.IN_KERNEL),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="unsupported device"):
            call()
