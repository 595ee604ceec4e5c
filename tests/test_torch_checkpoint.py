"""gmf_tpu's checkpoints in the port: the flax msgpack reader
(utils/flax_msgpack.py) against ``flax.serialization.msgpack_restore``,
``load_checkpoint``'s formats, the conversion to the port's models
(utils/model_io.py) and every entry point that takes a checkpoint, on
checkpoints gmf_tpu wrote (tests/torch_fixtures/gmf_checkpoints/, made by
its make_fixtures.py) and on trees written here with gmf_tpu's own
``save_checkpoint``.

Tolerances, each stated beside its assertion:
- the reader: equal to flax's restore in every value, shape and type;
- PointDSC through the registrar against gmf_tpu's: final transforms
  within 1e-3 and labels agreeing on >= 99% (tests/test_fused_model.py's
  bounds), in the modes gmf_tpu's loader builds and in the kernel modes
  (their plain versions here);
- OANet logits within 1e-5 of the largest (tests/test_torch_zoo.py);
- DGR register: correspondences equal, weights within 1e-5, T within 1e-4
  (tests/test_torch_dgr.py);
- an entry point on a gmf_tpu checkpoint against the same entry point on
  the port checkpoint of the same weights (``flax_to_state_dict`` of
  them): equal in every bit, but the times.
"""

import io
import json
import logging
import os
import re
import sys
from contextlib import redirect_stdout
from pathlib import Path

import flax.serialization as fs
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_eval_fixtures as fx
from gmf_tpu.utils.checkpoint import save_checkpoint as jax_save
from gmf_tpu_torch.eval.registration import PointDSCRegistrar
from gmf_tpu_torch.utils import flax_msgpack, model_io
from gmf_tpu_torch.utils.bridge import (flax_to_state_dict,
                                        sparse_resunet_to_state_dict)
from gmf_tpu_torch.utils.checkpoint import (is_gmf_tree, load_checkpoint,
                                            save_checkpoint)

torch.set_num_threads(2)
FIX = Path(__file__).resolve().parent / "torch_fixtures" / "gmf_checkpoints"
NAMES = ("pointdsc_trainer", "pointdsc_converted", "oanet", "fcgf",
         "inlier")
META = json.loads((FIX / "meta.json").read_text())
REF = dict(np.load(FIX / "reference.npz"))


def _same(ref, got, path="state"):
    """``got`` is ``ref`` (flax's restore) value for value, type for type;
    a bfloat16 array is a torch.bfloat16 tensor of the same bits."""
    if isinstance(ref, dict):
        assert isinstance(got, dict) and list(got) == list(ref), path
        for k in ref:
            _same(ref[k], got[k], f"{path}/{k}")
    elif isinstance(ref, list):
        assert isinstance(got, list) and len(got) == len(ref), path
        for i, (a, b) in enumerate(zip(ref, got)):
            _same(a, b, f"{path}[{i}]")
    elif getattr(ref, "dtype", None) == jnp.bfloat16:
        assert isinstance(got, torch.Tensor), path
        assert got.dtype == torch.bfloat16, path
        assert tuple(got.shape) == np.shape(ref), path
        np.testing.assert_array_equal(
            got.view(torch.int16).numpy(),
            np.asarray(ref).view(np.int16), err_msg=path)
    else:
        assert type(got) is type(ref), (path, type(got), type(ref))
        if isinstance(ref, np.ndarray):
            assert got.dtype == ref.dtype and got.shape == ref.shape, path
            np.testing.assert_array_equal(got, ref, err_msg=path)
        else:
            assert got == ref, (path, got, ref)


# -- the reader ---------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_reader_equals_flax_on_fixtures(name):
    data = (FIX / name / "state.msgpack").read_bytes()
    _same(fs.msgpack_restore(data), flax_msgpack.msgpack_restore(data))


def _trees():
    r = np.random.RandomState(0)
    return {
        "f32_bf16": {"params": {"kernel": r.randn(3, 4).astype(np.float32),
                                "bias": jnp.asarray(r.randn(4),
                                                    jnp.bfloat16)},
                     "batch_stats": {"mean": np.zeros(4, np.float32)}},
        "ints_bool": {"i32": np.arange(-5, 5, dtype=np.int32),
                      "i64": np.array([-2**40, 2**40], np.int64),
                      "u8": np.arange(256, dtype=np.uint8).reshape(16, 16),
                      "bool": np.array([[True, False], [False, True]]),
                      "f64": r.randn(2, 2), "f16": r.randn(3).astype(
                          np.float16)},
        "scalars": {"a0": np.array(1.5, np.float32), "i0": np.array(7),
                    "np_f32": np.float32(2.5), "np_i64": np.int64(-3),
                    "np_bool": np.bool_(True),
                    "bf16": jnp.bfloat16(1.25),
                    "py": [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32,
                           2**63, -1, -32, -33, -128, -129, -32769,
                           -2**31 - 1, 0.1, -1e300, True, False, None]},
        "containers": {"empty": {}, "nested": {"e": {}, "l": [[], [1, [2]],
                                                              {"k": "v"}]},
                       "ünï": "str", "s31": "x" * 31, "s255": "y" * 255,
                       "s70k": "z" * 70000, "bin": b"\x00\xff" * 40,
                       "many": {f"k{i}": i for i in range(20)},
                       "long": list(range(70000)),
                       "arr": [np.ones((0, 3), np.float32),
                               np.arange(3, dtype=np.int16)]},
        "complex": {"c": 1.5 - 2j, "c64": np.array([1 + 1j], np.complex64)},
    }


@pytest.mark.parametrize("case", sorted(_trees()))
def test_reader_equals_flax_on_trees(tmp_path, case):
    """Trees of every type gmf_tpu's trees use, serialised by flax into
    ``tmp_path`` and read back by both."""
    path = tmp_path / "state.msgpack"
    path.write_bytes(fs.msgpack_serialize(_trees()[case]))
    data = path.read_bytes()
    _same(fs.msgpack_restore(data), flax_msgpack.read_msgpack(str(path)))


def test_reader_through_save_checkpoint(tmp_path):
    """gmf_tpu's save_checkpoint of a tree with a config; the port's
    load_checkpoint returns flax's tree and the same config."""
    tree = _trees()["f32_bf16"]
    jax_save(str(tmp_path), tree, config={"model": {"num_layers": 3}})
    state, config = load_checkpoint(str(tmp_path))
    assert is_gmf_tree(state) and config == {"model": {"num_layers": 3}}
    _same(fs.msgpack_restore((tmp_path / "state.msgpack").read_bytes()),
          state)


def test_reader_chunked_arrays(monkeypatch):
    """flax's chunked form (monkeypatched to 64 bytes a chunk): arrays
    under dicts, a bf16 one, and an array that is the tree itself."""
    monkeypatch.setattr(fs, "MAX_CHUNK_SIZE", 64)
    r = np.random.RandomState(1)
    tree = {"a": r.randn(7, 5).astype(np.float32),
            "n": {"b": np.arange(100, dtype=np.int64), "small": np.ones(2)},
            "h": jnp.asarray(r.randn(3, 30), jnp.bfloat16)}
    data = fs.msgpack_serialize(tree)
    assert data.count(b"__msgpack_chunked_array__") == 3
    _same(fs.msgpack_restore(data), flax_msgpack.msgpack_restore(data))
    whole = fs.msgpack_serialize(r.randn(40).astype(np.float32))
    _same(fs.msgpack_restore(whole), flax_msgpack.msgpack_restore(whole))


def _ext_array(payload, code=1):
    import msgpack

    return msgpack.packb({"x": msgpack.ExtType(code, payload)})


@pytest.mark.parametrize("case,match", [
    ("truncated_1", "buffer ends"), ("truncated_half", "buffer ends"),
    ("truncated_last", "buffer ends"), ("extended", "bytes after"),
    ("type_c1", "0xc1"), ("ext_code", "ext code 9"),
    ("dtype", "unknown dtype"), ("size", "bytes for a float32"),
    ("int_key", "key of type int"), ("payload", "ndarray is"),
])
def test_reader_refuses_bad_bytes(case, match):
    import msgpack

    good = (FIX / "oanet" / "state.msgpack").read_bytes()
    data = {
        "truncated_1": good[:1], "truncated_half": good[:len(good) // 2],
        "truncated_last": good[:-1], "extended": good + b"\x00",
        "type_c1": b"\x81\xa1x\xc1",
        "ext_code": _ext_array(b"\x00", 9),
        "dtype": _ext_array(msgpack.packb([[1], "float99", b"\x00" * 4],
                                          use_bin_type=True)),
        "size": _ext_array(msgpack.packb([[2, 3], "float32", b"\x00" * 16],
                                         use_bin_type=True)),
        "int_key": msgpack.packb({1: 2}),
        "payload": _ext_array(msgpack.packb([1, 2], use_bin_type=True)),
    }[case]
    with pytest.raises(ValueError, match=match):
        flax_msgpack.msgpack_restore(data)


# -- load_checkpoint's formats ------------------------------------------------

def test_load_checkpoint_formats(tmp_path):
    """state.pt as before; state.msgpack as gmf_tpu's tree; a real
    state.orbax (gmf_tpu's save_checkpoint_orbax) refused by name with the
    conversion; an empty directory and a truncated state.msgpack named."""
    from gmf_tpu.utils.checkpoint import save_checkpoint_orbax

    sd = {"w": torch.arange(3.0)}
    save_checkpoint(str(tmp_path / "pt"), sd, config={"a": 1})
    state, config = load_checkpoint(str(tmp_path / "pt"))
    assert not is_gmf_tree(state) and torch.equal(state["w"], sd["w"])
    assert config == {"a": 1}
    save_checkpoint_orbax(str(tmp_path / "orbax"),
                          {"params": {"w": np.ones(3, np.float32)}},
                          config={"a": 1})
    assert os.path.isdir(tmp_path / "orbax" / "state.orbax")
    with pytest.raises(ValueError, match=r"state\.orbax.*OCDBT.*"
                       r"save_checkpoint\(p, state, config\)"):
        load_checkpoint(str(tmp_path / "orbax"))
    os.makedirs(tmp_path / "empty")
    with pytest.raises(FileNotFoundError, match=re.escape(
            str(tmp_path / "empty"))):
        load_checkpoint(str(tmp_path / "empty"))
    cut = tmp_path / "cut"
    os.makedirs(cut)
    data = (FIX / "fcgf" / "state.msgpack").read_bytes()
    (cut / "state.msgpack").write_bytes(data[:len(data) - 100])
    with pytest.raises(ValueError, match="state.msgpack.*buffer ends"):
        model_io.load_dgr(str(cut), str(cut))


# -- the conversion -----------------------------------------------------------

def _filled(shapes, seed):
    r = np.random.RandomState(seed)
    return jax.tree.map(
        lambda s: r.randn(*s.shape).astype(np.float32), shapes)


def test_full_width_pointdsc_loads_strict(tmp_path):
    """gmf_tpu's full-width PointDSC (12 layers, 128 channels), its shapes
    from jax.eval_shape of its init filled from a seed and written by its
    save_checkpoint in Trainer.save's layout: load_pointdsc loads it with
    strict=True, every tensor equal to flax_to_state_dict of the same
    arrays, in the modes gmf_tpu's loader builds."""
    from gmf_tpu.models import PointDSC as JaxPointDSC

    z = jax.ShapeDtypeStruct
    shapes = jax.eval_shape(
        JaxPointDSC().init, jax.random.PRNGKey(0), z((1, 16, 6), jnp.float32),
        z((1, 16, 3), jnp.float32), z((1, 16, 3), jnp.float32),
        z((1, 24, 32, 3), jnp.float32), z((1, 24, 32, 3), jnp.float32))
    v = _filled(shapes, 0)
    assert sum(a.size for a in jax.tree.leaves(v)) == 5_431_714
    fields = dict(num_layers=12, num_channels=128, k=40,
                  fused_attention=False, compat_cache="auto")
    jax_save(str(tmp_path), v, config={"model": fields})
    model = model_io.load_pointdsc(str(tmp_path), device="cpu")
    assert model.config["num_layers"] == 12 and not model.fused_attention
    want = flax_to_state_dict(v, 12)
    got = model.state_dict()
    assert set(got) == set(want)
    for k, t in got.items():
        assert torch.equal(t, want[k].to(t.dtype)), k


@pytest.mark.parametrize("config,kw,want", [
    # Trainer.save's layout: every field, fused_attention as recorded
    ({"model": {"num_layers": 2, "k": 10, "fused_attention": True,
                "compat_cache": "int8", "dtype": "bfloat16"}}, {},
     {"num_layers": 2, "k": 10, "fused_attention": True,
      "compat_cache": "int8"}),
    # convert_torch's layout: gmf_tpu's default (dense) where unrecorded
    ({"arch": "pointdsc", "model": {"num_layers": 2, "num_channels": 32}},
     {}, {"num_layers": 2, "num_channels": 32, "fused_attention": False}),
    # no config: the loader's keywords, over gmf_tpu's defaults
    (None, {"num_layers": 3, "inlier_threshold": 0.2},
     {"num_layers": 3, "inlier_threshold": 0.2, "fused_attention": False}),
])
def test_gmf_pointdsc_modes(config, kw, want):
    """The one mapping of a gmf_tpu config to the port's modes: the
    recorded fields gmf_tpu's PointDSC has (never dtype), gmf_tpu's
    defaults where they differ (fused_attention=False)."""
    assert model_io.gmf_pointdsc_kwargs(config, **kw) == want


def test_caller_modes_override_the_checkpoint():
    """A caller's keyword wins over the checkpoint's modes, as for the
    port's own checkpoints; the model is f32 unless asked."""
    path = str(FIX / "pointdsc_trainer")
    model = model_io.load_pointdsc(path, device="cpu")
    assert not model.fused_attention and model.dtype == torch.float32
    assert model.config["k"] == 10
    model = model_io.load_pointdsc(path, device="cpu", fused_attention=True,
                                   compat_cache="int8",
                                   dtype=torch.bfloat16)
    assert model.fused_attention and model.compat_cache == "int8"
    assert model.dtype == torch.bfloat16


def test_trees_that_do_not_fit_raise(tmp_path):
    """An OANet tree to the PointDSC loader and back refuses by arch; a
    PointDSC tree of more layers than its config says lists what it left
    unread; a tree lacking an array names its path, or, where the bridge
    takes the array as optional (a bias), the strict load lists the
    missing key."""
    with pytest.raises(ValueError, match="oanet"):
        model_io.load_pointdsc(str(FIX / "oanet"), device="cpu")
    with pytest.raises(ValueError, match="pointdsc"):
        model_io.load_oanet(str(FIX / "pointdsc_converted"), device="cpu")
    state, config = load_checkpoint(str(FIX / "pointdsc_trainer"))
    config["model"]["num_layers"] = 1
    jax_save(str(tmp_path / "deeper"), state, config=config)
    with pytest.raises(ValueError, match=r"arrays that a pointdsc of 1 "
                       r"layers does not have: batch_stats/encoder/"
                       r"NonLocal_layer_1/"):
        model_io.load_pointdsc(str(tmp_path / "deeper"), device="cpu")
    config["model"]["num_layers"] = 2
    del state["params"]["encoder"]["layer0"]["kernel"]
    jax_save(str(tmp_path / "lacking"), state, config=config)
    with pytest.raises(ValueError,
                       match="no params/encoder/layer0/kernel"):
        model_io.load_pointdsc(str(tmp_path / "lacking"), device="cpu")
    # a bias the bridge treats as optional: the strict load lists it
    state, _ = load_checkpoint(str(FIX / "pointdsc_trainer"))
    del state["params"]["classification_0"]["bias"]
    jax_save(str(tmp_path / "no_bias"), state, config=config)
    with pytest.raises(RuntimeError, match=r"Missing key\(s\).*"
                       r"classification\.0\.bias"):
        model_io.load_pointdsc(str(tmp_path / "no_bias"), device="cpu")
    fcgf, _ = load_checkpoint(str(FIX / "fcgf"))
    with pytest.raises(ValueError, match="not a SparseResUNet2"):
        model_io.tree_to_state_dict({"params": {"x": np.ones(1)}},
                                    "SparseResUNet2")
    assert model_io.tree_to_state_dict(fcgf, "ResUNetBN2C").keys() == \
        sparse_resunet_to_state_dict(fcgf).keys()


def test_zoo_tree_converts():
    """A registry net's tree (SimpleNetBN, as gmf_tpu inits it) converts
    by its arch and loads strictly into the port's net."""
    from gmf_tpu.models.registry import load_model as jax_load_model
    from gmf_tpu.sparse.kernel_map import build_pyramid
    from gmf_tpu.sparse.resunet import pyramid_to_arrays
    from gmf_tpu_torch.models.registry import load_model

    c3 = np.unique(np.random.RandomState(2).randint(0, 8, (60, 3)).astype(
        np.int32), axis=0)
    a3 = pyramid_to_arrays(build_pyramid(c3, 3, 3, granule=256))
    shapes = jax.eval_shape(
        jax_load_model("SimpleNetBN")(in_channels=1).init,
        jax.random.PRNGKey(0),
        jax.ShapeDtypeStruct((a3["mask_0"].shape[0], 1), jnp.float32), a3)
    tree = fs.msgpack_restore(fs.msgpack_serialize(_filled(shapes, 1)))
    net = load_model("SimpleNetBN")(in_channels=1)
    net.load_state_dict(model_io.tree_to_state_dict(tree, "SimpleNetBN"),
                        strict=True)


# -- forward parity against gmf_tpu's outputs ---------------------------------

def _samples():
    out = []
    for b, n in enumerate(REF["reg_n"]):
        s = {k: REF[f"reg_{k}"][b] for k in ("p_image", "q_image",
                                              "gt_trans")}
        for k in ("corr_pos", "src_keypts", "tgt_keypts", "labels"):
            s[k] = REF[f"reg_{k}"][b][:n]
        out.append(s)
    return out


def _check_registrar(res, name):
    """1e-3 on the transforms, >= 99% of the labels (module docstring)."""
    ref_t, ref_l = REF[f"reg_{name}_trans"], REF[f"reg_{name}_labels"]
    for (t, lab), rt, rl in zip(res, ref_t, ref_l):
        np.testing.assert_allclose(t, rt, rtol=0, atol=1e-3)
        assert (np.asarray(lab) == rl[:len(lab)]).mean() >= 0.99


@pytest.mark.parametrize("name", ["pointdsc_trainer", "pointdsc_converted"])
@pytest.mark.parametrize("modes", [
    {}, {"fused_attention": True, "compat_cache": "f32"},
    {"fused_attention": True, "compat_cache": "int8",
     "seed_solver": "fused"}], ids=["gmf_modes", "f32_cache", "int8_fused"])
def test_pointdsc_fixture_matches_gmf_tpu(name, modes):
    model = model_io.load_pointdsc(str(FIX / name), device="cpu", **modes)
    res = PointDSCRegistrar(model, buckets=(META["reg_bucket"],)
                            ).register_batch(_samples())
    _check_registrar(res, name)


def test_oanet_fixture_matches_gmf_tpu():
    """load_oanet gives an eval-mode net (gmf_tpu applies its OANet on the
    running statistics by default) whose logits are gmf_tpu's."""
    net = model_io.load_oanet(str(FIX / "oanet"), device="cpu")
    assert not net.training
    assert net.config == META["oanet"]
    with torch.no_grad():
        got = net(torch.from_numpy(REF["reg_corr_pos"][[0, 2]]),
                  return_logits=True).numpy()
    ref = REF["oanet_logits"]
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


def _dgr_engine(fcgf_state, inlier_state):
    from gmf_tpu_torch.models import dgr
    from gmf_tpu_torch.sparse.resunet import SparseResUNet2

    return dgr.DeepGlobalRegistration(
        fcgf_state, inlier_state, dgr.DGRConfig(**META["dgr_engine"]),
        fcgf_model=SparseResUNet2(**META["fcgf"]),
        inlier_model=SparseResUNet2(**META["inlier"]),
        fcgf_dim=META["dgr_fcgf_dim"], device="cpu")


def test_dgr_fixture_matches_gmf_tpu():
    eng = _dgr_engine(*model_io.load_dgr(str(FIX / "fcgf"),
                                         str(FIX / "inlier")))
    res = eng.register(REF["dgr_pcd0"], REF["dgr_pcd1"], REF["dgr_p_image"],
                       REF["dgr_q_image"])
    np.testing.assert_array_equal(res["corres"][0], REF["dgr_idx0"])
    np.testing.assert_array_equal(res["corres"][1], REF["dgr_idx1"])
    assert bool(res["used_safeguard"]) == bool(REF["dgr_used_safeguard"])
    np.testing.assert_allclose(res["weights"], REF["dgr_weights"], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(res["trans"], REF["dgr_trans"], rtol=0,
                               atol=1e-4)


# -- every entry point on a gmf_tpu checkpoint --------------------------------

@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """The eval trees of tests/torch_eval_fixtures.py and one tiny PointDSC
    as gmf_tpu wrote it and as the port writes it (``write_checkpoints``;
    the port's config records gmf_tpu's modes, so both load alike)."""
    root = str(tmp_path_factory.mktemp("ckpt"))
    t = fx.write_3dmatch_tree(root)
    t["kitti"] = fx.write_kitti_tree(os.path.join(root, "kitti"))
    t["jax_ckpt"], t["port_ckpt"] = fx.write_checkpoints(
        root, model={"fused_attention": False})
    return t


def _no_times(stats):
    return np.delete(np.asarray(stats), [9, 10], axis=1)


@pytest.mark.parametrize("case", ["3dmatch", "kitti", "3dlomatch"])
def test_eval_clis_accept_gmf_checkpoints(trees, tmp_path, case):
    """test_3dmatch, test_kitti and test_3dlomatch (eval/cli.py's
    load_eval_model) on gmf_tpu's checkpoint: the statistics of the port
    checkpoint of the same weights, in every bit but the times."""
    from gmf_tpu_torch.eval import test_3dlomatch, test_3dmatch, test_kitti
    from gmf_tpu_torch.utils.lru import host_io_cache

    module, argv = {
        "3dmatch": (test_3dmatch, ["--root", trees["root"], "--scenes",
                                   fx.SCENE]),
        "kitti": (test_kitti, ["--root", trees["kitti"], "--num-node",
                               "150"]),
        "3dlomatch": (test_3dlomatch, ["--root", trees["root"],
                                       "--pair-file", trees["pair_file"],
                                       "--num-node", "all"]),
    }[case]
    stats = {}
    for side in ("jax", "port"):
        host_io_cache().reset()
        np.random.seed(0)  # test_kitti samples num_node points
        stats[side] = module.main(argv + [
            "--checkpoint", trees[f"{side}_ckpt"], "--out",
            str(tmp_path / side), "--cpu"])["all_stats"]
    assert stats["jax"].shape[0] >= 2
    np.testing.assert_array_equal(_no_times(stats["jax"]),
                                  _no_times(stats["port"]))


def test_recurrent_sweeps_gmf_checkpoints(trees, tmp_path, caplog):
    """test_recurrent over a snapshot directory of gmf_tpu checkpoints:
    each one's recall as over their port copies."""
    from gmf_tpu_torch.eval import test_recurrent

    for seed in (0, 1):
        fx.write_checkpoints(str(tmp_path), name=f"epoch_{seed}", seed=seed,
                             model={"fused_attention": False})
    argv = ["--root", trees["root"], "--scenes", fx.SCENE, "--cpu"]
    recalls = {}
    for side in ("jax", "port"):
        caplog.clear()
        with caplog.at_level(logging.INFO):
            test_recurrent.main(argv + ["--snapshot-dir",
                                        str(tmp_path / side)])
        recalls[side] = dict(re.findall(r"(epoch_\d): recall=([\d.]+)%",
                                        caplog.text))
    assert len(recalls["jax"]) == 2 and recalls["jax"] == recalls["port"]


def test_multiway_registrar_on_gmf_checkpoint():
    """apps/multiway_cli.py's registrar from a gmf_tpu checkpoint (f32,
    dense on the CPU): gmf_tpu's outputs within the registrar's bounds."""
    from gmf_tpu_torch.apps.multiway_cli import make_registrar

    registrar = make_registrar(str(FIX / "pointdsc_trainer"),
                               torch.device("cpu"))
    _check_registrar(registrar.register_batch(_samples()),
                     "pointdsc_trainer")


def test_trainer_load_gmf_checkpoint():
    """Trainer.load reads a gmf_tpu checkpoint's params and batch_stats
    into the trainer's model: load_pointdsc's weights."""
    from gmf_tpu_torch.data.synthetic import SyntheticCorrespondenceLoader
    from gmf_tpu_torch.models import PointDSC
    from gmf_tpu_torch.train.trainer import TrainConfig, Trainer

    path = str(FIX / "pointdsc_trainer")
    loader = SyntheticCorrespondenceLoader(batch_size=1, num_corr=32,
                                           steps_per_epoch=1)
    model = PointDSC(device="cpu", seed=5, **META["pointdsc"])
    trainer = Trainer(model, TrainConfig(), loader, loader)
    trainer.load(path)
    want = model_io.load_pointdsc(path, device="cpu").state_dict()
    for k, t in trainer.model.state_dict().items():
        assert torch.equal(t, want[k]), k


def _tiny_dgr_checkpoints(root):
    """The --tiny nets (eval/test_dgr.py::tiny_nets) as gmf_tpu writes
    them: the FCGF net's bare variables and the inlier net in train_dgr's
    snapshot layout, shapes from gmf_tpu's init, arrays from a seed; and
    their port copies. Returns {side: (fcgf, inlier)}."""
    from gmf_tpu.sparse.kernel_map import build_pyramid
    from gmf_tpu.sparse.resunet import SparseResUNet2, pyramid_to_arrays

    narrow = dict(channels=(4, 8, 16, 32), tr_channels=(8, 8, 8, 16))
    fkw = dict(in_channels=1, out_channels=8, dim=3, conv1_kernel_size=3,
               normalize_feature=True, **narrow)
    ikw = dict(in_channels=1, out_channels=1, dim=6, conv1_kernel_size=3,
               with_gmf_fusion=True, image_dim=16, **narrow)
    r = np.random.RandomState(4)
    f32 = jnp.float32
    c3 = np.unique(r.randint(0, 8, (40, 3)).astype(np.int32), axis=0)
    a3 = pyramid_to_arrays(build_pyramid(c3, 4, 3, granule=256))
    fv = jax.eval_shape(SparseResUNet2(**fkw).init, jax.random.PRNGKey(0),
                        jax.ShapeDtypeStruct((a3["mask_0"].shape[0], 1),
                                             f32), a3)
    c6 = np.unique(r.randint(0, 4, (30, 6)).astype(np.int32), axis=0)
    a6 = pyramid_to_arrays(build_pyramid(c6, 4, 3, granule=256))
    img = jax.ShapeDtypeStruct((1, 16, 16, 3), f32)
    iv = jax.eval_shape(
        lambda x, a, p, q: SparseResUNet2(**ikw).init(
            jax.random.PRNGKey(1), x, a, p_image=p, q_image=q),
        jax.ShapeDtypeStruct((a6["mask_0"].shape[0], 1), f32), a6, img, img)

    def fill(shapes, seed):
        rr = np.random.RandomState(seed)

        def leaf(path, s):
            if path[-1].key == "var":
                return (0.5 + rr.rand(*s.shape)).astype(np.float32)
            scale = 0.3 if path[-1].key == "kernel" else 0.1
            return (scale * rr.randn(*s.shape)).astype(np.float32)

        return jax.tree_util.tree_map_with_path(leaf, shapes)

    fv, iv = fill(fv, 0), fill(iv, 1)
    out = {"jax": (os.path.join(root, "jax_fcgf"),
                   os.path.join(root, "jax_inlier")),
           "port": (os.path.join(root, "port_fcgf"),
                    os.path.join(root, "port_inlier"))}
    jax_save(out["jax"][0], fv)
    jax_save(out["jax"][1], iv, config={"dgr": {"voxel_size": 0.05},
                                        "descriptor": "fcgf"})
    save_checkpoint(out["port"][0], sparse_resunet_to_state_dict(fv))
    save_checkpoint(out["port"][1], sparse_resunet_to_state_dict(iv))
    return out


@pytest.fixture(scope="module")
def dgr_ckpts(tmp_path_factory):
    return _tiny_dgr_checkpoints(str(tmp_path_factory.mktemp("dgr")))


def test_test_dgr_accepts_gmf_checkpoints(dgr_ckpts, tmp_path):
    """test_dgr --tiny (load_dgr) on gmf_tpu's FCGF and inlier
    checkpoints: the rows of their port copies, in every bit."""
    from gmf_tpu_torch.data.ply import write_ply
    from gmf_tpu_torch.eval import test_dgr

    rng = np.random.RandomState(7)
    seq = tmp_path / "data" / fx.SCENE / "seq-01"
    os.makedirs(seq)
    xy = rng.rand(400, 2) * 2
    world = np.concatenate([xy, 0.2 * np.sin(3 * xy[:, :1]) * np.cos(
        2 * xy[:, 1:])], 1).astype(np.float32)
    R = fx._rot(0.3, 0.0).astype(np.float32)
    t = np.array([0.2, -0.1, 0.1], np.float32)
    write_ply(str(seq / "cloud_bin_0.ply"), world)
    write_ply(str(seq / "cloud_bin_1.ply"), world @ R.T + t)
    for i in range(2):
        fx._png(str(seq / f"cloud_bin_{i}_0.png"), rng, (16, 16))
    T = np.eye(4)
    T[:3, :3], T[:3, 3] = R, t
    with open(tmp_path / "data" / fx.SCENE / "gt.log", "w") as f:
        f.write("0 1 2\n" + "\n".join(" ".join(f"{v:.8f}" for v in row)
                                     for row in np.linalg.inv(T)) + "\n")
    rows = {}
    for side, (fcgf, inlier) in dgr_ckpts.items():
        rows[side] = test_dgr.main([
            "--root", str(tmp_path / "data"), "--scenes", fx.SCENE,
            "--fcgf-checkpoint", fcgf, "--inlier-checkpoint", inlier,
            "--tiny", "--voxel", "0.1", "--safeguard-min-weight", "0",
            "--out", str(tmp_path / side), "--cpu"])
    assert rows["jax"].shape == (1, 5)
    np.testing.assert_array_equal(rows["jax"], rows["port"])


def test_train_dgr_accepts_gmf_checkpoints(dgr_ckpts, tmp_path):
    """train_dgr --tiny with --fcgf-checkpoint and --resume on gmf_tpu's
    checkpoints: the epoch checkpoint of their port copies, in every
    bit."""
    from gmf_tpu_torch.train import train_dgr

    states = {}
    for side, (fcgf, inlier) in dgr_ckpts.items():
        out = str(tmp_path / side)
        train_dgr.main(["--dataset", "synthetic", "--tiny", "--cpu",
                        "--max-epoch", "1", "--steps-per-epoch", "1",
                        "--batch-size", "1", "--n-points", "200",
                        "--save-dir", out, "--fcgf-checkpoint", fcgf,
                        "--resume", inlier])
        states[side] = load_checkpoint(os.path.join(
            out, "checkpoint_epoch_1"))[0]
    for k, t in states["port"].items():
        assert torch.equal(states["jax"][k], t), k


def test_load_fcgf_full_width(tmp_path):
    """tools/precompute_descriptors.py::load_fcgf (build_kitti_pairs reads
    its FCGF through it too) on gmf_tpu's full-width FCGFNet variables:
    strict, equal to the bridge of the same arrays, in eval mode."""
    from gmf_tpu.sparse.kernel_map import build_pyramid
    from gmf_tpu.sparse.resunet import FCGFNet, pyramid_to_arrays
    from gmf_tpu_torch.tools.precompute_descriptors import load_fcgf

    c3 = np.unique(np.random.RandomState(3).randint(0, 6, (30, 3)).astype(
        np.int32), axis=0)
    a3 = pyramid_to_arrays(build_pyramid(c3, 4, 7, granule=256))
    shapes = jax.eval_shape(
        FCGFNet(conv1_kernel_size=7).init, jax.random.PRNGKey(0),
        jax.ShapeDtypeStruct((a3["mask_0"].shape[0], 1), jnp.float32), a3)
    v = _filled(shapes, 2)
    jax_save(str(tmp_path), v)
    model = load_fcgf(str(tmp_path), 7, "cpu")
    assert not model.training
    want = sparse_resunet_to_state_dict(v)
    for k, t in model.state_dict().items():
        assert torch.equal(t, want[k]), k


def test_print_checkpoint_matches_gmf_tpu(monkeypatch):
    """tools/print_checkpoint on a gmf_tpu checkpoint prints gmf_tpu's
    lines: the config, each leaf's path, shape and type, the count."""
    from gmf_tpu.tools import print_checkpoint as jax_print
    from gmf_tpu_torch.tools import print_checkpoint

    path = str(FIX / "pointdsc_trainer")
    monkeypatch.setattr(sys, "argv", ["print_checkpoint", path])
    with redirect_stdout(io.StringIO()) as ref:
        jax_print.main()
    with redirect_stdout(io.StringIO()) as got:
        n, total = print_checkpoint.main([path])
    assert got.getvalue() == ref.getvalue()
    assert total == 146_482
    assert min(n, 200) == len(ref.getvalue().splitlines()) - 2
