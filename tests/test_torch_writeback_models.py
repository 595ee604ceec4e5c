"""Models trained or converted by the port go back to gmf_tpu: the port's
writers with ``checkpoint_format="gmf"`` (``Trainer.save``,
``train_dgr``), loaded by gmf_tpu's own loaders and run there against the
port's outputs; the port's registration demo against gmf_tpu's; the
port's train -> checkpoint -> eval loop at a cut size.

Tolerances, each stated beside its assertion (those of
tests/test_torch_checkpoint.py):
- PointDSC through the registrar: final transforms within 1e-3 and labels
  agreeing on >= 99% (tests/test_fused_model.py's bounds);
- DGR register: correspondences equal, weights within 1e-5, T within 1e-4
  (tests/test_torch_dgr.py);
- the demo: the transform within 1e-3, both packages fed gmf_tpu's FPFH
  (on the demo's uniform random cloud the normals are ill-posed, and the
  two FPFH implementations' bins part on a third of the points, which
  moves the matches: tests/test_torch_tools.py holds FPFH itself).
"""

import dataclasses
import importlib.util
import io
import json
import os
import sys
from contextlib import redirect_stdout
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gmf_tpu.utils.checkpoint import load_checkpoint as jax_load
from gmf_tpu_torch.eval.registration import PointDSCRegistrar
from gmf_tpu_torch.utils.model_io import load_dgr, load_pointdsc
from test_torch_checkpoint import FIX, META, REF, _dgr_engine, _samples

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]


def _structure(tree):
    return {jax.tree_util.keystr(p): (tuple(a.shape), np.dtype(a.dtype).name)
            for p, a in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A tiny Trainer (2 layers, 32 channels, k=10: the fixtures' widths,
    the dense path gmf_tpu's loader builds) after 2 CPU steps, saved in
    gmf_tpu's format."""
    from gmf_tpu_torch.data.synthetic import SyntheticCorrespondenceLoader
    from gmf_tpu_torch.models import PointDSC
    from gmf_tpu_torch.train.trainer import TrainConfig, Trainer

    loader = SyntheticCorrespondenceLoader(batch_size=2, num_corr=64,
                                           steps_per_epoch=2,
                                           image_hw=(24, 32))
    model = PointDSC(device="cpu", seed=3, fused_attention=False,
                     **META["pointdsc"])
    trainer = Trainer(model, TrainConfig(lr=1e-3), loader, loader)
    for batch in loader:
        assert trainer.train_step(batch, 1)["skipped_step"] == 0.0
    path = str(tmp_path_factory.mktemp("trainer") / "model_best")
    trainer.save(path, "gmf")
    return trainer, path


def test_trainer_gmf_checkpoint_runs_in_gmf_tpu(trained):
    """gmf_tpu's load_pointdsc builds a model of the port's settings from
    the checkpoint; its registrar's transforms and labels are the port's
    trained model's (1e-3, 99%)."""
    from gmf_tpu.eval.registration import PointDSCRegistrar as JaxRegistrar
    from gmf_tpu.train.trainer import TrainConfig as JaxTrainConfig
    from gmf_tpu.utils.model_io import load_pointdsc as jax_load_pointdsc

    trainer, path = trained
    config = json.loads(Path(path, "config.json").read_text())
    assert set(config) == {f.name for f in dataclasses.fields(
        JaxTrainConfig)} | {"model"}
    jmodel, variables = jax_load_pointdsc(path)
    for key, value in config["model"].items():
        assert getattr(jmodel, key) == value, key
    assert not jmodel.fused_attention and jmodel.num_layers == 2
    samples = _samples()
    want = JaxRegistrar(jmodel, variables, buckets=(META["reg_bucket"],)
                        ).register_batch(samples)
    got = PointDSCRegistrar(trainer.model, buckets=(META["reg_bucket"],)
                            ).register_batch(samples)
    for (t, lab), (rt, rl) in zip(got, want):
        np.testing.assert_allclose(t, np.asarray(rt), rtol=0, atol=1e-3)
        assert (np.asarray(lab) == np.asarray(rl)).mean() >= 0.99
    # and back into the port: the trained weights, every bit
    again = load_pointdsc(path, device="cpu").state_dict()
    for k, t in trainer.model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(again[k], t), k


def test_gmf_tpu_trainer_loads_the_port_checkpoint(trained):
    """gmf_tpu's Trainer.load takes the directory: its params and
    batch_stats are the checkpoint's."""
    from gmf_tpu.data.synthetic import SyntheticCorrespondenceLoader
    from gmf_tpu.train.trainer import TrainConfig as JaxTrainConfig
    from gmf_tpu.train.trainer import Trainer as JaxTrainer
    from gmf_tpu.utils.model_io import load_pointdsc as jax_load_pointdsc

    _, path = trained
    jmodel, variables = jax_load_pointdsc(path)
    loader = SyntheticCorrespondenceLoader(batch_size=1, num_corr=32,
                                           steps_per_epoch=1,
                                           image_hw=(24, 32))
    jt = JaxTrainer(jmodel, JaxTrainConfig(), loader, loader)
    jt.load(path)
    loaded = {"params": jt.params, "batch_stats": jt.batch_stats}
    assert _structure(loaded) == _structure(variables)
    for a, b in zip(jax.tree.leaves(loaded), jax.tree.leaves(variables)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_train_dgr_gmf_checkpoint_runs_in_gmf_tpu(tmp_path):
    """train_dgr --tiny --checkpoint-format gmf: its epoch checkpoint (the
    6-D inlier net) and gmf_tpu's FCGF fixture in gmf_tpu's DGR engine
    register the fixture's pair as the port's engine does from the same
    directories (correspondences equal, weights 1e-5, T 1e-4); the config
    is gmf_tpu's train_dgr's."""
    from gmf_tpu.configs.presets import dgr_3dmatch as jax_dgr_3dmatch
    from gmf_tpu.models import dgr as jax_dgr
    from gmf_tpu.sparse.resunet import SparseResUNet2 as JaxResUNet
    from gmf_tpu_torch.models import dgr
    from gmf_tpu_torch.sparse.resunet import SparseResUNet2
    from gmf_tpu_torch.train import train_dgr

    train_dgr.main(["--dataset", "synthetic", "--tiny", "--cpu",
                    "--max-epoch", "1", "--steps-per-epoch", "1",
                    "--batch-size", "1", "--n-points", "200", "--save-dir",
                    str(tmp_path), "--checkpoint-format", "gmf"])
    ckpt = tmp_path / "checkpoint_epoch_1"
    assert not (ckpt / "state.pt").exists()
    config = json.loads((ckpt / "config.json").read_text())
    want_cfg = jax_dgr_3dmatch()
    want_cfg.max_epoch, want_cfg.batch_size = 1, 1
    assert config == json.loads(json.dumps(
        {"dgr": want_cfg.__dict__, "descriptor": "fcgf"}, default=str))
    inlier_kw = dict(in_channels=1, out_channels=1, dim=6,
                     conv1_kernel_size=3, with_gmf_fusion=True, image_dim=16,
                     channels=(4, 8, 16, 32), tr_channels=(8, 8, 8, 16))
    fcgf_kw = {k: tuple(v) if isinstance(v, list) else v
               for k, v in META["fcgf"].items()}
    args = (REF["dgr_pcd0"], REF["dgr_pcd1"], REF["dgr_p_image"],
            REF["dgr_q_image"])
    engine_kw = dict(META["dgr_engine"])
    want = jax_dgr.DeepGlobalRegistration(
        jax_load(str(FIX / "fcgf"))[0], jax_load(str(ckpt))[0],
        jax_dgr.DGRConfig(image_hw=(16, 16), **engine_kw),
        fcgf_model=JaxResUNet(**fcgf_kw), inlier_model=JaxResUNet(
            **inlier_kw), fcgf_dim=META["dgr_fcgf_dim"]).register(*args)
    got = dgr.DeepGlobalRegistration(
        *load_dgr(str(FIX / "fcgf"), str(ckpt)), dgr.DGRConfig(**engine_kw),
        fcgf_model=SparseResUNet2(**fcgf_kw),
        inlier_model=SparseResUNet2(**inlier_kw),
        fcgf_dim=META["dgr_fcgf_dim"], device="cpu").register(*args)
    for i in (0, 1):
        np.testing.assert_array_equal(got["corres"][i],
                                      np.asarray(want["corres"][i]))
    np.testing.assert_allclose(got["weights"], np.asarray(want["weights"]),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["trans"], np.asarray(want["trans"]),
                               rtol=0, atol=1e-4)


def test_fcgf_and_inlier_fixtures_through_the_writer(tmp_path):
    """The FCGF and inlier fixtures converted to the port's state dicts and
    written back by save_gmf_checkpoint: the DGR engine loaded from the
    copies registers as gmf_tpu did from the originals (reference.npz)."""
    from gmf_tpu_torch.utils.checkpoint import save_gmf_checkpoint
    from gmf_tpu_torch.utils.model_io import state_dict_to_tree

    fcgf, inlier = load_dgr(str(FIX / "fcgf"), str(FIX / "inlier"))
    save_gmf_checkpoint(str(tmp_path / "fcgf"),
                        state_dict_to_tree(fcgf, "SparseResUNet2"))
    save_gmf_checkpoint(str(tmp_path / "inlier"),
                        state_dict_to_tree(inlier, "SparseResUNet2"))
    res = _dgr_engine(*load_dgr(str(tmp_path / "fcgf"),
                                str(tmp_path / "inlier"))).register(
        REF["dgr_pcd0"], REF["dgr_pcd1"], REF["dgr_p_image"],
        REF["dgr_q_image"])
    np.testing.assert_array_equal(res["corres"][0], REF["dgr_idx0"])
    np.testing.assert_array_equal(res["corres"][1], REF["dgr_idx1"])
    np.testing.assert_allclose(res["weights"], REF["dgr_weights"], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(res["trans"], REF["dgr_trans"], rtol=0,
                               atol=1e-4)


# -- the demo -----------------------------------------------------------------

def _gmf_tpu_fpfh(monkeypatch):
    """Both demos' descriptors from gmf_tpu's compute_fpfh (module
    docstring)."""
    from gmf_tpu.ops.fpfh import compute_fpfh
    from gmf_tpu_torch.ops import fpfh

    monkeypatch.setattr(fpfh, "compute_fpfh", lambda xyz: torch.from_numpy(
        np.array(compute_fpfh(jnp.asarray(xyz.cpu().numpy())))))


def _run_jax_demo(monkeypatch, argv):
    spec = importlib.util.spec_from_file_location(
        "gmf_tpu_demo_registration", ROOT / "examples" /
        "demo_registration.py")
    demo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(demo)
    monkeypatch.setattr(sys, "argv", ["demo_registration", *argv])
    with redirect_stdout(io.StringIO()) as out:
        demo.main()
    return out.getvalue()


def _run_port_demo(argv):
    from gmf_tpu_torch.examples import demo_registration

    with redirect_stdout(io.StringIO()) as out:
        res = demo_registration.main(argv)
    return out.getvalue(), res


@pytest.mark.parametrize("checkpoint", [True, False],
                         ids=["checkpoint", "random"])
def test_demo_matches_gmf_tpus(checkpoint, tmp_path, monkeypatch):
    """--cpu --tiny on the synthetic pair: with gmf_tpu's checkpoint the
    port's transform is gmf_tpu's demo's (1e-3); with random weights
    (each package's own) both print SUCCESS, RE and TE on that line."""
    _gmf_tpu_fpfh(monkeypatch)
    argv = ["--cpu", "--tiny", "--save-trans"]
    ckpt = ["--checkpoint", str(FIX / "pointdsc_trainer")] if checkpoint \
        else []
    ref = _run_jax_demo(monkeypatch, argv + [str(tmp_path / "jax.npy")]
                        + ckpt)
    out, (trans, labels, re, te) = _run_port_demo(
        argv + [str(tmp_path / "port.npy")] + ckpt)
    for text in (ref, out):
        assert "SUCCESS" in text and "RE=" in text and "TE=" in text, text
    assert re < 15 and te < 0.3
    np.testing.assert_array_equal(np.load(tmp_path / "port.npy"), trans)
    if checkpoint:
        np.testing.assert_allclose(trans, np.load(tmp_path / "jax.npy"),
                                   rtol=0, atol=1e-3)
        assert out.splitlines()[:3] == ref.splitlines()[:3]


# -- the loop -----------------------------------------------------------------

def test_train_eval_loop_writes_gmf_tpu_checkpoints(tmp_path):
    """gmf_tpu_torch.tools.train_eval_synthetic at 1 epoch of 1 step: it
    prints the script's lines, and the checkpoints it writes are gmf_tpu's,
    read by its load_pointdsc and load_checkpoint into trees of its own
    init's paths, shapes and dtypes."""
    from gmf_tpu.sparse.kernel_map import build_pyramid
    from gmf_tpu.sparse.resunet import SparseResUNet2 as JaxResUNet
    from gmf_tpu.sparse.resunet import pyramid_to_arrays
    from gmf_tpu.utils.model_io import load_pointdsc as jax_load_pointdsc
    from gmf_tpu_torch.tools import train_eval_synthetic

    with redirect_stdout(io.StringIO()) as out:
        res = train_eval_synthetic.main([
            "--cpu", "--max-epoch", "1", "--steps-per-epoch", "1",
            "--save-dir", str(tmp_path)])
    text = out.getvalue()
    for line in ("=== PointDSC+GMF synthetic loop", "held-out recall",
                 "classifier confidence BCE: trained",
                 "=== DGR+GMF synthetic loop (fpfh/surface", "untrained: ",
                 "trained: success"):
        assert line in text, line
    assert res["pointdsc"]["recall"] >= 0.75
    assert np.isfinite(res["pointdsc"]["bce_trained"])

    best = os.path.join(res["pointdsc"]["save_dir"], "model_best")
    assert os.path.exists(os.path.join(best, "state.msgpack"))
    jmodel, variables = jax_load_pointdsc(best)
    z = jax.ShapeDtypeStruct
    shapes = jax.eval_shape(
        jmodel.init, jax.random.PRNGKey(0), z((1, 16, 6), jnp.float32),
        z((1, 16, 3), jnp.float32), z((1, 16, 3), jnp.float32),
        z((1, 24, 32, 3), jnp.float32), z((1, 24, 32, 3), jnp.float32))
    assert _structure(variables) == _structure(dict(shapes))

    tree, config = jax_load(os.path.join(res["dgr"]["save_dir"],
                                         "best_val_checkpoint"))
    assert set(config) == {"dgr"}
    c6 = np.unique(np.random.RandomState(0).randint(0, 4, (30, 6)).astype(
        np.int32), axis=0)
    a6 = pyramid_to_arrays(build_pyramid(c6, 4, 3, granule=256))
    img = jax.ShapeDtypeStruct((1, 16, 16, 3), jnp.float32)
    ikw = dict(in_channels=1, out_channels=1, dim=6, conv1_kernel_size=3,
               with_gmf_fusion=True, image_dim=16, channels=(4, 8, 16, 32),
               tr_channels=(8, 8, 8, 16))
    iv = jax.eval_shape(
        lambda x, a, p, q: JaxResUNet(**ikw).init(
            jax.random.PRNGKey(1), x, a, p_image=p, q_image=q),
        jax.ShapeDtypeStruct((a6["mask_0"].shape[0], 1), jnp.float32), a6,
        img, img)
    assert _structure(tree) == _structure(dict(iv))
