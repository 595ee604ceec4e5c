"""The port writes gmf_tpu's checkpoints: the flax msgpack writer
(utils/flax_msgpack.py::msgpack_serialize) against
``flax.serialization.msgpack_serialize``, the inverse bridges
(utils/model_io.py::state_dict_to_tree) against gmf_tpu's own trees, and
``save_gmf_checkpoint`` and ``convert_torch --checkpoint-format gmf``
against gmf_tpu's writers.

Tolerances, each stated beside its assertion:
- the writer: flax's bytes, byte for byte;
- a fixture read, converted to the port's state_dict and back, and
  written: the committed file, byte for byte;
- the full-width PointDSC's tree: gmf_tpu's paths, shapes and dtypes, and
  gmf_tpu's save_checkpoint's bytes;
- convert_torch: gmf_tpu's state.msgpack byte for byte, its config.json
  equal as JSON;
- OANet's logits from the written checkpoint in gmf_tpu within 1e-5 of
  the largest of the port's (tests/test_torch_zoo.py's bound).
"""

import json
import sys

import flax.serialization as fs
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from gmf_tpu.utils.checkpoint import load_checkpoint as jax_load
from gmf_tpu.utils.checkpoint import save_checkpoint as jax_save
from gmf_tpu_torch.utils import flax_msgpack, model_io
from gmf_tpu_torch.utils.bridge import flax_to_state_dict
from gmf_tpu_torch.utils.checkpoint import (load_checkpoint,
                                            save_gmf_checkpoint)
from test_torch_checkpoint import FIX, META, NAMES, _filled

torch.set_num_threads(2)
BF16 = ml_dtypes.bfloat16


# -- the writer against flax's ------------------------------------------------

INTS = [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**63,
        2**64 - 1, -1, -32, -33, -128, -129, -32768, -32769, -2**31,
        -2**31 - 1, -2**63]
LENGTHS = [0, 1, 31, 32, 255, 256, 65535, 65536]


def _cases():
    r = np.random.RandomState(0)
    out = {f"int_{v}": {"v": v} for v in INTS}
    out.update({f"str_{n}": {"s": "x" * n} for n in LENGTHS})
    out.update({f"bin_{n}": {"b": b"\xff" * n} for n in LENGTHS})
    out.update({
        "str_utf8": {"s": "ünï ✓"}, "bytearray": {"b": bytearray(b"ab")},
        "memoryview": {"b": memoryview(b"abc")},
        "floats": {"f": [0.1, -1e300, 0.0, float("inf"), 1.5]},
        "bool_none": {"t": True, "f": False, "n": None},
        "nested_unsorted": {"b": {"z": 1, "a": {"y": [], "c": {}}}, "a": 2},
        "empty_dict": {}, "empty_list": [], "top_list": [1, "a", None],
        "map_15_16": {"m15": {f"k{i:02d}": i for i in range(15)},
                      "m16": {f"k{i:02d}": i for i in range(16)}},
        "array_15_16_70000": {"a": list(range(15)), "b": list(range(16)),
                              "c": list(range(70000))},
        "int_keys": {3: "c", 1: "a", 2: "b"},
        "f32": {"a": r.randn(3, 4).astype(np.float32)},
        "f16": {"a": r.randn(5).astype(np.float16)},
        "bf16": {"a": r.randn(2, 3).astype(BF16)},
        "int8": {"a": np.arange(-128, 128, dtype=np.int8).reshape(16, 16)},
        "int64": {"a": np.array([-2**62, 0, 2**62], np.int64)},
        "bool": {"a": np.array([[True, False], [False, True]])},
        "zero_d": {"f": np.array(1.5, np.float32), "i": np.array(7),
                   "b": np.array(True), "h": np.array(2.5, BF16)},
        "empty_arrays": {"a": np.ones((0, 3), np.float32),
                         "b": np.zeros(0, np.int8)},
        "non_contiguous": {"a": r.randn(4, 6).astype(np.float32)[::2, 1::2],
                           "t": r.randn(3, 3).T},
        "np_scalars": {"f32": np.float32(2.5), "f64": np.float64(-1.0),
                       "i64": np.int64(-3), "u8": np.uint8(200),
                       "b": np.bool_(True), "h": BF16(1.25)},
        "complex": {"c": 1.5 - 2j, "c64": np.array([1 + 1j], np.complex64),
                    "s": np.complex128(3 - 1j)},
        "arrays_in_lists": {"l": [np.arange(3, dtype=np.int16),
                                  [np.ones(2, np.float32)]]},
    })
    return out


CASES = _cases()


@pytest.mark.parametrize("case", sorted(CASES, key=str))
def test_writer_equals_flax(case):
    tree = CASES[case]
    assert flax_msgpack.msgpack_serialize(tree) == fs.msgpack_serialize(
        tree)


def test_writer_tensors_as_flax_writes_their_arrays():
    """Torch tensors (bf16 among them, a transposed and a 0-d one) are
    written as flax writes the same arrays, and read back as they were."""
    r = np.random.RandomState(1)
    a, h = r.randn(4, 3).astype(np.float32), r.randn(5).astype(BF16)
    tensors = {"a": torch.from_numpy(a).T, "h": torch.from_numpy(
        h.view(np.int16)).view(torch.bfloat16), "z": torch.tensor(3.0),
        "i": torch.arange(4), "b": torch.tensor([True, False])}
    arrays = {"a": a.T, "h": h, "z": np.array(3.0, np.float32),
              "i": np.arange(4), "b": np.array([True, False])}
    data = flax_msgpack.msgpack_serialize(tensors)
    assert data == fs.msgpack_serialize(arrays)
    back = flax_msgpack.msgpack_restore(data)
    assert torch.equal(back["h"], tensors["h"])
    np.testing.assert_array_equal(back["a"], a.T)


def test_writer_chunked_arrays(monkeypatch):
    """flax's chunked form (monkeypatched to 64 bytes a chunk in both):
    arrays under dicts, a bf16 one and a tensor, an array that is the tree
    itself; an array in a list is not chunked, as in flax."""
    for module in (fs, flax_msgpack):
        monkeypatch.setattr(module, "MAX_CHUNK_SIZE", 64)
    r = np.random.RandomState(1)
    tree = {"a": r.randn(7, 5).astype(np.float32),
            "n": {"b": np.arange(100, dtype=np.int64), "small": np.ones(2)},
            "h": r.randn(3, 30).astype(BF16), "l": [np.arange(40.0)]}
    data = flax_msgpack.msgpack_serialize(tree)
    assert data == fs.msgpack_serialize(tree)
    assert data.count(b"__msgpack_chunked_array__") == 3
    t = {"t": torch.arange(50, dtype=torch.float32)}
    assert flax_msgpack.msgpack_serialize(t) == fs.msgpack_serialize(
        {"t": np.arange(50, dtype=np.float32)})
    whole = r.randn(40).astype(np.float32)
    assert flax_msgpack.msgpack_serialize(whole) == fs.msgpack_serialize(
        whole)


def test_writer_takes_tuples_as_lists():
    """flax's strict packer refuses a tuple; the writer takes it as the
    list of its items, which flax reads back as a list."""
    tree = {"t": (1, "a", (2.5,))}
    with pytest.raises(TypeError):
        fs.msgpack_serialize(tree)
    data = flax_msgpack.msgpack_serialize(tree)
    assert data == fs.msgpack_serialize({"t": [1, "a", [2.5]]})
    assert fs.msgpack_restore(data) == {"t": [1, "a", [2.5]]}


@pytest.mark.parametrize("tree,error,match", [
    ({"a": {"b": object()}}, TypeError, "state/a/b: a leaf of type"),
    ({"a": [1, {2, 3}]}, TypeError, r"state/a\[1\]: a leaf of type "
     "builtins.set"),
    ({"x": 2**64}, ValueError, "state/x: the int 18446744073709551616"),
    ({"x": -2**63 - 1}, ValueError, "state/x: the int"),
    ({"o": np.array([None])}, TypeError, "state/o: an array of dtype "
     "object"),
    ({1: 1, "a": 2}, TypeError, "keys of types that do not sort"),
    ({"e": torch.zeros(2, dtype=torch.float8_e4m3fn)}, TypeError,
     "state/e: a tensor of torch.float8_e4m3fn"),
])
def test_writer_refuses_what_flax_does_not_write(tree, error, match):
    """Each leaf flax refuses (or NumPy cannot hold) raises, naming it."""
    with pytest.raises(error, match=match):
        flax_msgpack.msgpack_serialize(tree)


# -- the inverse bridges ------------------------------------------------------

def _arch(name):
    return {"oanet": "oanet", "fcgf": "SparseResUNet2",
            "inlier": "SparseResUNet2"}.get(name, "pointdsc")


@pytest.mark.parametrize("name", NAMES)
def test_fixture_round_trip_is_byte_equal(name, tmp_path):
    """Each gmf_tpu-written fixture: read, converted to the port's
    state_dict, back to gmf_tpu's tree and written, byte for byte the
    committed file, by msgpack_serialize and by save_gmf_checkpoint."""
    arch = _arch(name)
    layers = META["oanet" if arch == "oanet" else "pointdsc"]["num_layers"]
    tree, config = load_checkpoint(str(FIX / name))
    sd = model_io.tree_to_state_dict(tree, arch, layers)
    back = model_io.state_dict_to_tree(sd, arch, layers)
    want = (FIX / name / "state.msgpack").read_bytes()
    assert flax_msgpack.msgpack_serialize(back) == want
    save_gmf_checkpoint(str(tmp_path), back, config)
    assert (tmp_path / "state.msgpack").read_bytes() == want
    if config is None:  # the bare FCGF tree
        assert not (tmp_path / "config.json").exists()
    else:
        assert (tmp_path / "config.json").read_text() == \
            (FIX / name / "config.json").read_text()


def _full_width_shapes():
    from gmf_tpu.models import PointDSC as JaxPointDSC

    z = jax.ShapeDtypeStruct
    return jax.eval_shape(
        JaxPointDSC().init, jax.random.PRNGKey(0), z((1, 16, 6), jnp.float32),
        z((1, 16, 3), jnp.float32), z((1, 16, 3), jnp.float32),
        z((1, 24, 32, 3), jnp.float32), z((1, 24, 32, 3), jnp.float32))


def _structure(tree):
    return {jax.tree_util.keystr(p): (tuple(a.shape), np.dtype(a.dtype).name)
            for p, a in jax.tree_util.tree_leaves_with_path(tree)}


def test_full_width_pointdsc_tree_is_gmf_tpus(tmp_path):
    """The port's full-width PointDSC (12 layers, 128 channels) as a tree:
    gmf_tpu's init's paths, shapes and dtypes (jax.eval_shape, no
    forward); save_gmf_checkpoint's bytes are gmf_tpu's save_checkpoint's
    of the same NumPy tree (21.7 MB), and it loads back into the port
    strictly, every tensor equal."""
    from gmf_tpu_torch.models import PointDSC

    model = PointDSC(device="cpu", seed=4)
    tree = model_io.state_dict_to_tree(model.state_dict(), "pointdsc", 12)
    assert _structure(tree) == _structure(dict(_full_width_shapes()))
    save_gmf_checkpoint(str(tmp_path / "port"), tree, {"model": {}})
    jax_save(str(tmp_path / "jax"), tree, {"model": {}})
    data = (tmp_path / "port" / "state.msgpack").read_bytes()
    assert len(data) > 21_000_000
    assert data == (tmp_path / "jax" / "state.msgpack").read_bytes()
    again = model_io.tree_to_state_dict(jax_load(str(tmp_path / "port"))[0],
                                        "pointdsc", 12)
    for k, t in model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(again[k], t), k


def test_bridges_invert_gmf_tpus_trees():
    """gmf_tpu's full-width PointDSC tree (eval_shape filled from a seed)
    -> the port's state_dict -> back: every array equal."""
    v = _filled(_full_width_shapes(), 3)
    back = model_io.state_dict_to_tree(flax_to_state_dict(v, 12),
                                       "pointdsc", 12)
    assert jax.tree.structure(back) == jax.tree.structure(dict(v))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(dict(v))):
        np.testing.assert_array_equal(a, b)


def test_zoo_trees_invert():
    """A SimpleNetBN and a PyramidNet6INBN tree as gmf_tpu inits them (its
    "_bn" norm names) -> the port's state_dict -> back: every path and
    array equal."""
    from gmf_tpu.models.registry import load_model as jax_load_model
    from gmf_tpu.sparse.kernel_map import build_pyramid
    from gmf_tpu.sparse.resunet import pyramid_to_arrays

    for seed, (name, levels) in enumerate((("SimpleNetBN", 3),
                                           ("PyramidNet6INBN", 6))):
        c3 = np.unique(np.random.RandomState(2).randint(0, 12, (90, 3))
                       .astype(np.int32), axis=0)
        a3 = pyramid_to_arrays(build_pyramid(c3, levels, 3, granule=256))
        shapes = jax.eval_shape(
            jax_load_model(name)(in_channels=1).init, jax.random.PRNGKey(0),
            jax.ShapeDtypeStruct((a3["mask_0"].shape[0], 1), jnp.float32),
            a3)
        v = _filled(shapes, seed)
        sd = model_io.tree_to_state_dict(v, name)
        back = model_io.state_dict_to_tree(sd, name)
        assert _structure(back) == _structure(dict(v)), name
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(dict(v))):
            np.testing.assert_array_equal(a, b)


def test_bad_state_dicts_raise_naming_the_entry():
    """A state_dict lacking an entry names it; entries the tree would
    leave out are named, all of them; the torch-only counters are neither
    needed nor carried."""
    sd = model_io.tree_to_state_dict(load_checkpoint(str(FIX / "oanet"))[0],
                                     "oanet", 4)
    lacking = {k: v for k, v in sd.items() if k != "l1_1.0.weight"}
    with pytest.raises(ValueError, match=r"not that of a oanet of 4 layers"
                       r": it has no 'l1_1\.0\.weight'"):
        model_io.state_dict_to_tree(lacking, "oanet", 4)
    extra = {**sd, "l1_1.9.weight": torch.ones(2), "head.bias": torch.ones(1)}
    with pytest.raises(ValueError, match=r"2 entries .*: head\.bias, "
                       r"l1_1\.9\.weight"):
        model_io.state_dict_to_tree(extra, "oanet", 4)
    bare = {k: v for k, v in sd.items() if "num_batches_tracked" not in k}
    assert flax_msgpack.msgpack_serialize(model_io.state_dict_to_tree(
        bare, "oanet", 4)) == (FIX / "oanet" / "state.msgpack").read_bytes()
    with pytest.raises(ValueError, match="no converter"):
        model_io.state_dict_to_tree(sd, "Transformer")
    with pytest.raises(ValueError, match="of 2 layers.*NonLocal_layer_2"):
        deeper = model_io.tree_to_state_dict(
            load_checkpoint(str(FIX / "pointdsc_trainer"))[0], "pointdsc", 2)
        deeper.update({k.replace("_layer_1", "_layer_2"): v
                       for k, v in deeper.items() if "_layer_1." in k})
        model_io.state_dict_to_tree(deeper, "pointdsc", 2)


# -- the converter against gmf_tpu's ------------------------------------------

def _random_state(model, seed):
    r = np.random.RandomState(seed)
    sd = {}
    for k, t in model.state_dict().items():
        if t.is_floating_point():
            a = r.randn(*t.shape) * 0.2
            if k.endswith("running_var"):
                a = 0.5 + r.rand(*t.shape)
            t = torch.from_numpy(a.astype(np.float32))
        sd[k] = t
    return sd


@pytest.mark.parametrize("arch", ["pointdsc", "oanet"])
def test_convert_torch_gmf_equals_gmf_tpus(arch, tmp_path, monkeypatch):
    """convert_torch --checkpoint-format gmf and gmf_tpu's convert_torch
    on one torch file: state.msgpack equal in bytes, config.json equal as
    JSON; for OANet, gmf_tpu's logits from it are the port's net's."""
    from gmf_tpu.utils import convert_torch as jax_convert
    from gmf_tpu_torch.models import PointDSC
    from gmf_tpu_torch.models.oanet import OANet
    from gmf_tpu_torch.utils import convert_torch

    if arch == "pointdsc":
        net = PointDSC(device="cpu", **META["pointdsc"])
        layers = META["pointdsc"]["num_layers"]
    else:
        net = OANet(**META["oanet"])
        layers = META["oanet"]["num_layers"]
    net.load_state_dict(_random_state(net, 5))
    torch.save(net.state_dict(), tmp_path / "net.pth")
    common = ["--input", str(tmp_path / "net.pth"), "--model", arch,
              "--num-layers", str(layers)]
    convert_torch.main(common + ["--out", str(tmp_path / "port"),
                                 "--checkpoint-format", "gmf"])
    monkeypatch.setattr(sys, "argv", ["convert_torch", *common, "--out",
                                      str(tmp_path / "jax")])
    jax_convert.main()
    for side in ("port", "jax"):
        assert (tmp_path / side / "config.json").exists()
    assert (tmp_path / "port" / "state.msgpack").read_bytes() == \
        (tmp_path / "jax" / "state.msgpack").read_bytes()
    assert json.loads((tmp_path / "port" / "config.json").read_text()) == \
        json.loads((tmp_path / "jax" / "config.json").read_text())
    if arch == "oanet":
        from gmf_tpu.models.oanet import OANet as JaxOANet

        x = np.random.RandomState(6).randn(2, 40, 6).astype(np.float32)
        ref = np.asarray(JaxOANet(**META["oanet"]).apply(
            jax_load(str(tmp_path / "port"))[0], jnp.asarray(x),
            return_logits=True))
        with torch.no_grad():
            got = net.eval()(torch.from_numpy(x), return_logits=True).numpy()
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())
