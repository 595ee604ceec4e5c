"""Package rules of gmf_tpu_torch: no JAX anywhere, the card by default."""

import ast
import functools
import pkgutil
import subprocess
import sys
from pathlib import Path
from typing import Dict, List

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
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "gmf_tpu", "PIL", "msgpack",
             "orbax")


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


# writing gmf_tpu's checkpoints, the demo and the train-eval loop (not
# counterparts of a gmf_tpu module, but of examples/ and scripts/),
# likewise
WRITEBACK = ("utils/flax_msgpack.py", "utils/bridge.py",
             "utils/checkpoint.py", "utils/model_io.py",
             "examples/__init__.py", "examples/demo_registration.py",
             "tools/train_eval_synthetic.py")


@pytest.mark.parametrize("path", WRITEBACK)
def test_no_jax_checks_cover_the_writeback(path):
    assert _reached(path)


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


# -- the public surface, name by name ----------------------------------------
#
# Module parity above asks only that a file exist. The check below reads
# both trees with ``ast`` (it imports neither package) and collects, for
# every module of gmf_tpu: each public top-level function and class, each
# public method of a public class (flax's ``__call__`` is torch's
# ``forward``), and each parameter of those, a dataclass or flax field
# counting as a parameter of its class's constructor (bases in the same
# tree included). Each item must have its counterpart at the same module
# path in gmf_tpu_torch, defined there or imported into it; the port may
# add parameters of its own (``device=`` and the like). An item the port
# names otherwise stands in ALIASES (gmf_tpu name -> the port's name); an
# item it does not port stands in NOT_PORTED with its reason, each reason
# also under ROADMAP.md §3 "Deliberate differences" in the same words. A
# key "*(name=)" covers that parameter wherever it occurs. An entry that
# clears nothing fails the check too, so that the tables stay true.

ALIASES = {
    "ops/fused_attention.compat_attention_reference":
        "compat_attention_plain",
    "utils/checkpoint.save_checkpoint(state=)": "state_dict",
    "geometry/ransac.ransac_registration(key=)": "generator",
    "models/dgr.DeepGlobalRegistration(fcgf_variables=)": "fcgf_state",
    "models/dgr.DeepGlobalRegistration(inlier_variables=)": "inlier_state",
    "models/pointdsc.NonLocalNet.__call__(corr_compatibility=)": "attention",
    "train/dgr_trainer.WeightedProcrustesTrainer(fcgf_model=)": "fcgf",
    "train/dgr_trainer.WeightedProcrustesTrainer(inlier_model=)": "inlier",
}

_PALLAS = ("a Pallas tiling or interpret switch: the port's CUDA kernels "
           "pick their own tiles, and a CPU tensor takes the plain version")
_VARIABLES = ("flax variables passed beside the model: the port's modules "
              "carry their weights (load_state_dict)")
_FUNCTIONAL = ("the functional training idiom (optax state threaded "
               "through jitted steps): the port's Trainer holds the model "
               "and a torch optimizer, Trainer.train_step takes a step and "
               "learning_rate gives the schedule")
_TPU_GATHER = ("a TPU gather tier of the device kernel map: the port runs "
               "one exact sorted-key probe (sparse/device_maps.py) whose "
               "arrays equal every tier's")
NOT_PORTED = {
    "*(interpret=)": _PALLAS,
    "*(block_q=)": _PALLAS,
    "*(block_k=)": _PALLAS,
    "*(block_s=)": _PALLAS,
    "*(block_n=)": _PALLAS,
    "*(ts=)": _PALLAS,
    "ops/fused_attention.padded_len": (
        "the Pallas kernels' padding to whole blocks: the CUDA kernels "
        "mask the ragged tile themselves"),
    "*(dtype=)": (
        "flax's per-module compute dtype: the port sets the compute type "
        "with nn/compute.py's compute_dtype (set_compute_dtype), its "
        "parameters staying f32"),
    "*(train=)": (
        "flax's train flag: a torch module's mode (.train() / .eval()) "
        "picks batch statistics or running ones"),
    "nn/resnet.ImageEncoder.setup": (
        "flax's setup hook: a torch module builds its children in "
        "__init__"),
    "sparse/device_maps.device_kernel_map(method=)": _TPU_GATHER,
    "sparse/device_maps.device_kernel_map(compact=)": _TPU_GATHER,
    "sparse/device_maps.device_kernel_map(dense_cells=)": _TPU_GATHER,
    "sparse/device_maps.device_kernel_map(lane_group=)": _TPU_GATHER,
    "sparse/device_maps.device_kernel_map_split": _TPU_GATHER,
    "sparse/device_maps.device_kernel_map_split2": _TPU_GATHER,
    "sparse/device_maps.device_kernel_map_srcdense": _TPU_GATHER,
    "sparse/device_maps.plan_split_probe": _TPU_GATHER,
    "utils/checkpoint.save_checkpoint_orbax": (
        "orbax, JAX's checkpointer: the port writes torch checkpoints "
        "with save_checkpoint and gmf_tpu's state.msgpack with "
        "save_gmf_checkpoint"),
    "train/trainer.TrainState": _FUNCTIONAL,
    "train/trainer.TrainState.tree": _FUNCTIONAL,
    "train/trainer.make_train_step": _FUNCTIONAL,
    "train/trainer.make_eval_step": _FUNCTIONAL,
    "train/trainer.make_optimizer(steps_per_epoch=)": _FUNCTIONAL,
    "train/trainer.Trainer(rng_seed=)": (
        "flax's init key: the port's model draws its weights when it is "
        "built (PointDSC(seed=)) and Trainer takes it built"),
    "train/descriptor.ContrastiveDescriptorTrainer.variables": (
        "flax variables of the trained net: the port trains the FCGF "
        "module in place, whose state_dict() holds them "
        "(ContrastiveDescriptorTrainer.fcgf)"),
    "train/descriptor.ContrastiveDescriptorTrainer(fcgf_vars=)": _VARIABLES,
    "train/dgr_trainer.WeightedProcrustesTrainer(fcgf_vars=)": _VARIABLES,
    "train/dgr_trainer.WeightedProcrustesTrainer(inlier_vars=)": _VARIABLES,
    "tools/precompute_descriptors.extract_fcgf(variables=)": _VARIABLES,
    "eval/registration.PointDSCRegistrar(variables=)": _VARIABLES,
    "models/pointdsc.NonLocalBlock(ring_mesh=)": (
        "a module field in flax: the port passes the mesh at call time, "
        "PointDSC(ring_mesh=) handing it to NonLocalNet.forward "
        "and NonLocalBlock.forward (ring_mesh=)"),
    "models/pointdsc.NonLocalNet(ring_mesh=)": (
        "a module field in flax: the port passes the mesh at call time, "
        "PointDSC(ring_mesh=) handing it to NonLocalNet.forward "
        "and NonLocalBlock.forward (ring_mesh=)"),
    "data/threedmatch.ThreeDLoMatchTest(kw=)": (
        "gmf_tpu's **kw: the port names its keys as parameters "
        "(descriptor, in_dim, inlier_threshold, use_mutual, image_hw, "
        "device_match)"),
}


def _params(fn) -> List[str]:
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    names += [x.arg for x in (a.vararg, a.kwarg) if x is not None]
    return [n for n in names if n not in ("self", "cls")]


def _fields(cls) -> List[str]:
    """A class body's annotated fields (dataclass and flax), ClassVars
    left out."""
    return [s.target.id for s in cls.body
            if isinstance(s, ast.AnnAssign) and isinstance(s.target, ast.Name)
            and "ClassVar" not in ast.unparse(s.annotation)]


class _Tree:
    """A package's modules parsed, and its names resolved through its own
    imports and assignments."""

    def __init__(self, root: Path):
        self.pkg = root.name
        self.mods = {str(p.relative_to(root)): ast.parse(p.read_text())
                     for p in sorted(root.rglob("*.py"))}

    def _rel(self, module: str):
        base = module.replace(".", "/")
        for rel in (f"{base}.py", f"{base}/__init__.py" if base
                    else "__init__.py"):
            if rel in self.mods:
                return rel
        return None

    def _source(self, rel: str, node: ast.ImportFrom):
        """The in-package module an import names (dotted, package-relative),
        or None for another package."""
        if node.level == 0:
            mod = node.module or ""
            if mod != self.pkg and not mod.startswith(self.pkg + "."):
                return None
            return mod[len(self.pkg) + 1:]
        parts = rel[:-3].split("/")
        parts = parts[:-1] if parts[-1] != "__init__" else parts[:-1]
        parts = parts[:len(parts) - (node.level - 1)]
        return ".".join(parts + (node.module.split(".") if node.module
                                 else []))

    def resolve(self, rel: str, name: str, depth: int = 0):
        """(module, node) of ``name`` as module ``rel`` sees it, or None."""
        if depth > 8 or rel not in self.mods:
            return None
        found = None
        for s in self.mods[rel].body:
            if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)) and s.name == name:
                found = (rel, s)
            elif isinstance(s, ast.ImportFrom):
                mod = self._source(rel, s)
                for a in s.names:
                    if mod is not None and (a.asname or a.name) == name:
                        src = self._rel(mod)
                        found = (self.resolve(src, a.name, depth + 1)
                                 if src else None) or found
            elif isinstance(s, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id == name
                    for t in s.targets):
                found = ((self.resolve(rel, s.value.id, depth + 1)
                          if isinstance(s.value, ast.Name) else None)
                         or (rel, s))
        return found

    def members(self, rel: str, cls: ast.ClassDef, depth: int = 0):
        """(methods {name: node}, constructor parameters) of a class, its
        bases in the same tree included."""
        methods, ctor = {}, []
        for b in cls.bases:
            base = self.resolve(rel, b.id) if isinstance(b, ast.Name) else None
            if base and isinstance(base[1], ast.ClassDef) and depth < 8:
                m, c = self.members(*base, depth + 1)
                methods.update(m)
                ctor += c
        ctor += _fields(cls)
        for s in cls.body:
            if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef)):
                methods[s.name] = s
        if "__init__" in methods:
            ctor += _params(methods["__init__"])
        return methods, ctor

    def surface(self) -> Dict[str, List[str]]:
        """{"module/path.qualname": [parameters]} of every public item."""
        out = {}
        for rel, mod in self.mods.items():
            stem = rel[:-3]
            for s in mod.body:
                if getattr(s, "name", "_").startswith("_"):
                    continue
                if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    out[f"{stem}.{s.name}"] = _params(s)
                elif isinstance(s, ast.ClassDef):
                    methods, ctor = self.members(rel, s)
                    out[f"{stem}.{s.name}"] = ctor
                    for m, node in methods.items():
                        if m == "__call__" or not m.startswith("_"):
                            out[f"{stem}.{s.name}.{m}"] = _params(node)
        return out


def surface_gaps(ref_root: Path, port_root: Path, aliases: Dict[str, str],
                 not_ported: Dict[str, str]):
    """(gaps, unused table keys): every public item of the tree at
    ``ref_root`` without its counterpart in the tree at ``port_root`` and
    without an entry in either table; and the entries that cleared
    nothing."""
    ref, port = _Tree(ref_root), _Tree(port_root)
    used, gaps = set(), []

    def cleared(key: str) -> bool:
        hits = [k for k in (key, "*" + key[key.index("("):]
                            if key.endswith("=)") else None)
                if k in not_ported]
        used.update(hits)
        return bool(hits)

    for item, params in sorted(ref.surface().items()):
        stem, qual = item.split(".", 1)
        rel = f"{stem}.py"
        parts = qual.split(".")
        if item in aliases:
            used.add(item)
            parts[-1] = aliases[item]
        hit = port.resolve(rel, parts[0])
        node = None
        if hit is not None and len(parts) == 1:
            node = hit[1]
        elif hit is not None and isinstance(hit[1], ast.ClassDef):
            methods, _ = port.members(*hit)
            node = methods.get(parts[1]) or (methods.get("forward")
                                             if parts[1] == "__call__"
                                             else None)
        if node is None:
            if not cleared(item):
                gaps.append(item)
            continue
        if isinstance(node, ast.ClassDef):
            have = port.members(hit[0], node)[1]
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            have = _params(node)
        else:
            continue  # an assigned name: its parameters are not in view
        for p in params:
            key = f"{item}({p}=)"
            if key in aliases:
                used.add(key)
                p = aliases[key]
            if p not in have and not cleared(key):
                gaps.append(key)
    return gaps, sorted((set(aliases) | set(not_ported)) - used)


def test_every_public_name_and_parameter_has_its_counterpart():
    """gmf_tpu's public surface, name by name, in gmf_tpu_torch (the notes
    above); every gap is listed at once."""
    gaps, unused = surface_gaps(ROOT / "gmf_tpu", ROOT / "gmf_tpu_torch",
                                ALIASES, NOT_PORTED)
    assert not gaps, "missing in gmf_tpu_torch:\n" + "\n".join(gaps)
    assert not unused, "table entries that clear nothing:\n" + "\n".join(
        unused)
    assert all(reason.strip() for reason in NOT_PORTED.values())


def _write_tree(root: Path, files: Dict[str, str]) -> Path:
    for rel, text in files.items():
        (root / rel).parent.mkdir(parents=True, exist_ok=True)
        (root / rel).write_text(text)
    return root


def test_surface_check_catches_each_kind_of_gap(tmp_path):
    """The check on two tiny trees: a deleted function, a deleted
    parameter and a deleted field are each reported, and an alias or a
    reason clears each one; a table entry that clears nothing is
    reported too."""
    ref = _write_tree(tmp_path / "ref" / "pkg", {
        "__init__.py": "",
        "a.py": ("def f(x, y=1):\n    pass\n\n"
                 "def g(z):\n    pass\n\n"
                 "class M:\n    width: int = 4\n    depth: int = 0\n\n"
                 "    def __call__(self, x, train=False):\n        pass\n"),
    })
    whole = {
        "__init__.py": "",
        "a.py": ("def f(x, y=1, device=None):\n    pass\n\n"
                 "def g(z):\n    pass\n\n"
                 "class M:\n    def __init__(self, width=4, depth=0):\n"
                 "        pass\n\n"
                 "    def forward(self, x, train=False):\n        pass\n"),
    }
    port = _write_tree(tmp_path / "port" / "pkg_torch", whole)
    assert surface_gaps(ref, port, {}, {}) == ([], [])

    cases = {
        # a deleted function, cleared by an alias to the port's name
        "function": (("def g(z):", "def h(z):"), "a.g",
                     {"a.g": "h"}, {}),
        # a deleted parameter, cleared by a reason
        "parameter": (("f(x, y=1, device", "f(x, device"), "a.f(y=)",
                      {}, {"a.f(y=)": "a reason"}),
        # a deleted field, cleared by an alias and by a wildcard reason
        "field": (("width=4, depth=0", "width=4"), "a.M(depth=)",
                  {"a.M(depth=)": "width"}, {"*(depth=)": "a reason"}),
    }
    for name, ((old, new), gap, alias, reason) in cases.items():
        broken = dict(whole, **{"a.py": whole["a.py"].replace(old, new)})
        port = _write_tree(tmp_path / name / "pkg_torch", broken)
        assert surface_gaps(ref, port, {}, {}) == ([gap], []), name
        if alias:
            assert surface_gaps(ref, port, alias, {}) == ([], []), name
        if reason:
            assert surface_gaps(ref, port, {}, reason) == ([], []), name
    port = _write_tree(tmp_path / "whole" / "pkg_torch", whole)
    assert surface_gaps(ref, port, {"a.f": "f2"}, {"a.q": "x"}) == (
        ["a.f"], ["a.q"])
