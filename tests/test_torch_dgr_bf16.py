"""gmf_tpu_torch's bf16 DGR nets, the trainer's validation, the
contrastive descriptor trainer and the train_dgr command line, against
gmf_tpu on the set-up of tests/test_torch_dgr_train.py
(tests/torch_dgr_parity.py), CPU.

bf16 nets: gmf_tpu's ``dtype=jnp.bfloat16`` nets applied to f32
variables (a checkpoint's) compute the image encoder, both fusion layers,
``conv1_tr`` and ``final`` in bf16 and the sparse trunk in f32 (its
modules take their parameters' type); each layer's output type is held
to gmf_tpu's (``capture_intermediates``), and the port's bf16 output lies
no farther from the f32 output than 1.5x gmf_tpu's bf16 output does
(the two packages round bf16 in different places: XLA keeps f32 inside
its fusions).

Tolerances, each beside its assertion.
"""

import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gmf_tpu.sparse.kernel_map import build_pyramid as jax_build_pyramid
from gmf_tpu.sparse.resunet import SparseResUNet2 as JaxNet
from gmf_tpu.sparse.resunet import pyramid_to_arrays as jax_arrays
from gmf_tpu.train import descriptor as jdesc
from gmf_tpu_torch.models import dgr
from gmf_tpu_torch.sparse.kernel_map import build_pyramid
from gmf_tpu_torch.sparse.resunet import SparseResUNet2, pyramid_to_arrays
from gmf_tpu_torch.train import descriptor
from gmf_tpu_torch.train import train_dgr
from gmf_tpu_torch.utils.bridge import sparse_resunet_to_state_dict
from gmf_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from gmf_tpu_torch.utils.model_io import load_dgr
from torch_dgr_parity import (FKW, G, IKW, make_world, port_trainer)

torch.set_num_threads(2)
BF16_FACTOR = 1.5   # the port's bf16 distance from f32 over gmf_tpu's


@pytest.fixture(scope="module")
def world():
    return make_world()


def test_validate(world):
    """validate on 2 pairs: hit ratio, precision, recall, F1 and success
    equal; rre within 0.25 deg and rte within 2e-3 m. The refinement's
    cumulative stop counter sits at its threshold on the second pair, so
    the packages stop 4 iterations apart there (100 against 96), which
    moves its rre by 0.098 deg and its rte by 8.3e-4 m (measured; on the
    first pair, where the counts agree, 6e-6 deg and 1e-7 m)."""
    jt = world["jax"].trainer()
    pt = port_trainer(world["fv"], world["iv"], jt)
    # gmf_tpu's validate applies the net eagerly; jitted, it runs the
    # same graph in a few seconds (both pairs' maps have one shape)
    jt.inlier = types.SimpleNamespace(apply=jax.jit(jt.inlier.apply))
    jv, pv = jt.validate(world["pairs"]), pt.validate(world["pairs"])
    assert set(jv) == set(pv)
    for k in ("hit_ratio", "precision", "recall", "f1", "success"):
        assert pv[k] == pytest.approx(float(jv[k]), abs=1e-9), k
    assert pv["rre"] == pytest.approx(jv["rre"], abs=0.25)
    assert pv["rte"] == pytest.approx(jv["rte"], abs=2e-3)


def test_device_maps_on_the_cpu(world):
    """Maps built by the device builder on the CPU give the host maps'
    gradients: the same maps, bit for bit."""
    grads = []
    for device_maps in (False, True):
        pt = port_trainer(world["fv"], world["iv"])
        pt.device_maps = device_maps
        grads.append(pt.train_pair(world["pairs"][1])[0])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


@pytest.mark.parametrize("descriptor,feature_type", [
    ("fpfh", "ones"), ("fcgf", "feats"), ("fcgf", "coords")])
def test_trainer_modes(world, descriptor, feature_type):
    """The trainer's other descriptor and input-feature modes (their
    parts held to gmf_tpu elsewhere: FPFH and inlier_input_features in
    tests/test_torch_dgr.py): a step of one pair applies, its loss
    finite, and validate gives finite statistics."""
    from gmf_tpu_torch.configs.presets import DGRTrainConfig
    from gmf_tpu_torch.models.dgr import inlier_input_feature_dim
    from gmf_tpu_torch.train.dgr_trainer import WeightedProcrustesTrainer

    desc_dim = 33 if descriptor == "fpfh" else FKW["out_channels"]
    ikw = dict(IKW, in_channels=inlier_input_feature_dim(feature_type,
                                                         desc_dim))
    torch.manual_seed(0)
    pt = WeightedProcrustesTrainer(
        SparseResUNet2(**FKW), SparseResUNet2(**ikw),
        DGRTrainConfig(voxel_size=0.08, inlier_feature_type=feature_type),
        voxel_cap_granule=G, corr_cap_granule=G, descriptor=descriptor,
        device="cpu")
    pair = world["pairs"][0]
    m = pt.train_step([pair])
    assert m["skipped"] == 0.0 and np.isfinite(m["loss"])
    assert pt.applied_steps == 1
    v = pt.validate([pair])
    assert all(np.isfinite(x) for x in v.values())


# -- bf16 nets -------------------------------------------------------------


def _inputs(world, dim):
    """A pyramid for each package and the net's inputs: the first pair's
    cloud 0 (3-D) or its first 120 voxel pairs (6-D)."""
    pair = world["pairs"][0]
    coords = pair["coords0"] if dim == 3 else np.unique(np.concatenate(
        [pair["coords0"][:120], pair["coords1"][:120]], 1), axis=0)
    ja = jax_arrays(jax_build_pyramid(coords, 4, granule=G))
    pa = pyramid_to_arrays(build_pyramid(coords, 4, granule=G), "cpu")
    img = np.random.RandomState(2).rand(2, 1, 16, 16, 3).astype(np.float32)
    return ja, pa, np.ones((G, 1), np.float32), img


# gmf_tpu's module path -> the port's module, for the layers whose type
# the two packages must agree on
LAYERS = {
    "inlier": {("conv1",): "conv1", ("norm1",): "norm1",
               ("block1",): "block1", ("conv4",): "conv4",
               ("block4",): "block4", ("conv2_tr",): "conv2_tr",
               ("block2_tr",): "block2_tr",
               ("img_encoder", "backbone"): "img_encoder.backbone",
               ("image_fusion",): "image_fusion",
               ("perceiver_io", "cpe"): "perceiver_io.cpe",
               ("perceiver_io", "cross_attn"):
                   "perceiver_io.cross_attend_blocks.0.fn",
               ("perceiver_io",): "perceiver_io",
               ("conv1_tr",): "conv1_tr", ("final",): "final"},
    "fcgf": {("conv1",): "conv1", ("block1",): "block1",
             ("block2_tr",): "block2_tr", ("conv1_tr",): "conv1_tr",
             ("final",): "final"},
}


def _dtypes(out):
    if isinstance(out, (tuple, list)):
        return tuple(_dtypes(o) for o in out)
    return str(out.dtype).replace("torch.", "")


@pytest.mark.parametrize("net", ["inlier", "fcgf"])
def test_bf16_net(world, net):
    """Each listed layer's output type as gmf_tpu's bf16 net's, and the
    output: f32, within BF16_FACTOR x gmf_tpu's bf16 distance from the
    f32 output (f32 outputs of the two packages within 1e-5)."""
    kw, v = (IKW, world["iv"]) if net == "inlier" else (FKW, world["fv"])
    ja, pa, feats, img = _inputs(world, kw["dim"])
    jkw = dict(p_image=jnp.asarray(img[0]), q_image=jnp.asarray(img[1])) \
        if net == "inlier" else {}
    pkw = dict(p_image=torch.from_numpy(img[0]),
               q_image=torch.from_numpy(img[1])) if net == "inlier" else {}
    j32 = np.asarray(jax.jit(JaxNet(**kw).apply)(v, jnp.asarray(feats), ja,
                                                 **jkw))
    j16, inter = jax.jit(lambda *a, **k: JaxNet(**kw, dtype=jnp.bfloat16)
                         .apply(*a, **k, capture_intermediates=True,
                                mutable=["intermediates"]))(
        v, jnp.asarray(feats), ja, **jkw)
    assert j16.dtype == jnp.float32

    outs = {}
    port = {}
    for dtype in (torch.float32, torch.bfloat16):
        m = SparseResUNet2(**kw, dtype=dtype)
        m.load_state_dict(sparse_resunet_to_state_dict(v), strict=True)
        for p in m.parameters():
            assert p.dtype == torch.float32  # parameters stay f32
        def hook(name):
            def record(mod, args, out):
                outs.setdefault((dtype, name), _dtypes(out))
            return record

        hooks = [m.get_submodule(name).register_forward_hook(hook(name))
                 for name in LAYERS[net].values()]
        with torch.no_grad():
            port[dtype] = m.eval()(torch.from_numpy(feats), pa, **pkw)
        for h in hooks:
            h.remove()
    assert port[torch.bfloat16].dtype == torch.float32
    inter = inter["intermediates"]
    for path, name in LAYERS[net].items():
        node = inter
        for key in path:
            node = node[key]
        want = _dtypes(node["__call__"][0])
        assert outs[torch.bfloat16, name] == want, (name, want)
        assert "bfloat16" not in str(outs[torch.float32, name])
    np.testing.assert_allclose(port[torch.float32].numpy(), j32, rtol=0,
                               atol=1e-5)
    d_jax = float(np.abs(np.asarray(j16) - j32).max())
    d_port = float(np.abs(port[torch.bfloat16].numpy() - j32).max())
    assert 0 < d_port <= BF16_FACTOR * d_jax, (d_port, d_jax)


def test_engine_bf16_nets():
    """DGRConfig(net_dtype="bfloat16") builds bf16 default nets; an engine
    given nets keeps their type, as gmf_tpu's. Unknown types raise."""
    eng = dgr.DeepGlobalRegistration(
        config=dgr.DGRConfig(net_dtype="bfloat16"), device="cpu")
    assert eng.fcgf.dtype == eng.inlier.dtype == torch.bfloat16
    assert eng.inlier.final.compute_dtype == torch.bfloat16
    assert eng.inlier.conv1.kernel.dtype == torch.float32
    with pytest.raises(ValueError, match="net_dtype"):
        dgr.DGRConfig(net_dtype="float16").check()


# -- the contrastive descriptor trainer ----------------------------------


def test_hardest_contrastive_loss():
    r = np.random.RandomState(0)
    f0, f1 = (r.randn(60, 8).astype(np.float32) for _ in range(2))
    pos0, pos1 = r.randint(0, 60, 32), r.randint(0, 60, 32)
    mask = (np.arange(32) < 27).astype(np.float32)
    xyz1 = r.rand(60, 3).astype(np.float32)
    jl, jm = jdesc.hardest_contrastive_loss(
        *map(jnp.asarray, (f0, f1, pos0, pos1, mask, xyz1)),
        exclude_radius=0.2)
    pl, pm = descriptor.hardest_contrastive_loss(
        *map(torch.from_numpy, (f0, f1, pos0, pos1, mask, xyz1)),
        exclude_radius=0.2)
    np.testing.assert_allclose(float(pl), float(jl), rtol=1e-6)
    for k in jm:
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=1e-6)


def test_descriptor_step(world):
    """One ContrastiveDescriptorTrainer step on the same pair and draw:
    the metrics within 1e-5 relative, the batch statistics within 1e-5,
    the parameters as tests/test_torch_dgr_train.py::test_train_steps
    holds Adam's first step (entries with a gradient near 0 to |step| <=
    lr, the others within 1e-5)."""
    pair, lr = world["pairs"][0], 1e-2
    jt = jdesc.ContrastiveDescriptorTrainer(
        JaxNet(**FKW), world["fv"], voxel_size=0.08, granule=G, n_pos=64,
        lr=lr)
    jm = jt.train_pair(pair, rng=np.random.RandomState(3))
    net = SparseResUNet2(**FKW)
    net.load_state_dict(sparse_resunet_to_state_dict(world["fv"]))
    pt = descriptor.ContrastiveDescriptorTrainer(
        net, voxel_size=0.08, granule=G, n_pos=64, lr=lr, device="cpu")
    before = {n: w.detach().clone() for n, w in net.named_parameters()}
    grads = {}
    step = pt.optimizer.step

    def record():
        grads.update({n: w.grad.clone() for n, w in net.named_parameters()})
        return step()

    pt.optimizer.step = record
    pm = pt.train_pair(pair, rng=np.random.RandomState(3))
    assert set(pm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(pm[k], jm[k], rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    want = sparse_resunet_to_state_dict(jax.tree.map(np.asarray,
                                                     jt.variables))
    for n, w in net.state_dict().items():
        if n.endswith("num_batches_tracked"):
            continue
        if n in grads:
            g = grads[n].abs()
            near0 = g <= 1e-3 * g.max()
            assert ((w - before[n]).abs()[near0] <= lr * 1.0001).all(), n
            w = torch.where(near0, want[n], w)
        np.testing.assert_allclose(w.numpy(), want[n].numpy(), rtol=0,
                                   atol=1e-5, err_msg=n)


# -- the command line ------------------------------------------------------


def test_train_dgr_cli(tmp_path):
    """train_dgr --tiny --cpu, 1 epoch of 1 step of 1 pair: the epoch and
    best checkpoints with their configs, the snapshot of the port's
    sources, a checkpoint that load_dgr reads into an engine that
    registers a pair, and --mesh refused by its ROADMAP item."""
    from gmf_tpu_torch.data.dgr_loader import make_dgr_pair
    from gmf_tpu_torch.eval.test_dgr import tiny_nets

    torch.manual_seed(3)
    fcgf_ckpt = save_checkpoint(str(tmp_path / "fcgf"),
                                tiny_nets()[0].state_dict())
    out = str(tmp_path / "snap")
    train_dgr.main(["--dataset", "synthetic", "--tiny", "--cpu",
                    "--max-epoch", "1", "--steps-per-epoch", "1",
                    "--batch-size", "1", "--save-dir", out,
                    "--fcgf-checkpoint", fcgf_ckpt])
    state, config = load_checkpoint(os.path.join(out, "checkpoint_epoch_1"))
    assert config["descriptor"] == "fcgf"
    assert config["dgr"]["batch_size"] == 1
    with open(os.path.join(out, "best_val_checkpoint", "config.json")) as f:
        assert "dgr" in json.load(f)
    for mod in ("train/dgr_trainer.py", "train/train_dgr.py",
                "models/dgr.py", "sparse/resunet.py", "configs/presets.py"):
        assert os.path.exists(os.path.join(out, "src", "gmf_tpu_torch", mod))
    fcgf, inlier = tiny_nets()
    eng = dgr.DeepGlobalRegistration(
        *load_dgr(fcgf_ckpt, os.path.join(out, "checkpoint_epoch_1")),
        dgr.DGRConfig(voxel_size=0.05, voxel_cap_granule=G,
                      corr_cap_granule=G, safeguard_ransac_iters=256),
        fcgf_model=fcgf, inlier_model=inlier, device="cpu")
    p = make_dgr_pair(np.random.RandomState(0), n_points=300,
                      image_hw=(16, 16))
    res = eng.register(p["pcd0"], p["pcd1"], p["p_image"][None],
                       p["q_image"][None])
    assert res["trans"].shape == (4, 4) and np.isfinite(res["trans"]).all()
    for k, v in inlier.state_dict().items():
        assert torch.equal(v, state[k]), k
    with pytest.raises(SystemExit, match="item 6"):
        train_dgr.main(["--dataset", "synthetic", "--tiny", "--cpu",
                        "--mesh", "2", "--save-dir", out])
