"""gmf_tpu_torch's model zoo against gmf_tpu on the same inputs (CPU, f32):
the hypercross kernel maps, the zoo's sparse nets (hypercross ResUNet,
SimpleNet, PyramidNet), the correspondence blocks and OANet, the model
registry, and the reference-checkpoint converters.

Clouds of ~300 voxels (extent 40, so that 6 levels stay populated); nets
at narrow widths with the presets' structure; weights and statistics
drawn from numpy seeds and carried across by utils/bridge.py. Tolerances:
- offsets, kernel maps and pyramids: equal in every bit, on the host
  (native and NumPy builders) and the device builder;
- sparse nets: 1e-5 of the output's largest entry (ATen and XLA:CPU sum
  each convolution's products in other orders);
- blocks and OANet: 1e-5 of the largest entry, outputs and (train mode)
  the updated running statistics;
- converters: equal in every bit to gmf_tpu's conversion followed by the
  bridge; a converted net's forward within 1e-5 of gmf_tpu's.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gmf_tpu.models import blocks as jblocks
from gmf_tpu.models.oanet import OANet as JaxOANet
from gmf_tpu.models.registry import MODELS as JAX_MODELS
from gmf_tpu.sparse import kernel_map as jkm
from gmf_tpu.sparse.pyramidnet import SparsePyramidNet as JaxPyramidNet
from gmf_tpu.sparse.resunet import SparseResUNet2 as JaxResUNet
from gmf_tpu.sparse.resunet import pyramid_to_arrays as jax_arrays
from gmf_tpu.sparse.simpleunet import SimpleSparseUNet as JaxSimpleNet
from gmf_tpu.utils import convert_minkowski as jcm
from gmf_tpu.utils import convert_torch as jct
from gmf_tpu_torch.models import blocks
from gmf_tpu_torch.models.oanet import OANet
from gmf_tpu_torch.models.registry import MODELS, load_model
from gmf_tpu_torch.sparse import kernel_map
from gmf_tpu_torch.sparse.device_maps import build_pyramid_arrays_device
from gmf_tpu_torch.sparse.pyramidnet import SparsePyramidNet
from gmf_tpu_torch.sparse.resunet import SparseResUNet2, pyramid_to_arrays
from gmf_tpu_torch.sparse.simpleunet import SimpleSparseUNet
from gmf_tpu_torch.tools import print_checkpoint
from gmf_tpu_torch.utils import convert_minkowski, convert_torch, model_io
from gmf_tpu_torch.utils.bridge import (oanet_to_state_dict,
                                        sparse_resunet_to_state_dict,
                                        sparse_zoo_to_state_dict)

torch.set_num_threads(2)


def _coords(seed=0, dim=3, n=300, extent=40):
    r = np.random.RandomState(seed)
    return np.unique(r.randint(0, extent, (n, dim)).astype(np.int32), axis=0)


def _close(got, ref, rtol):
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    scale = max(float(np.abs(ref).max()), 1e-12)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rtol * scale)


def _random_variables(module, seed, *args, **kwargs):
    """Variables of a flax module from its shapes (``eval_shape``, no
    compile): kernels scaled by 1/sqrt(fan-in), biases, scales and the
    batch statistics away from their init so that eval mode reads them."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args,
                            **kwargs)
    r = np.random.RandomState(seed)

    def fill(path, a):
        name, sh = path[-1].key, a.shape
        if name == "kernel":
            x = r.randn(*sh) / np.sqrt(np.prod(sh[:-1]))
        elif name == "scale":
            x = 1 + 0.2 * r.randn(*sh)
        elif name == "var":
            x = 0.5 + r.rand(*sh)
        else:  # bias, mean
            x = 0.1 * r.randn(*sh)
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _assert_arrays_equal(got, want):
    """A port pyramid dict against gmf_tpu's ``pyramid_to_arrays``."""
    got = {k: v for k, v in got.items() if k != "conv1_volume"}
    assert set(got) == set(want), set(got) ^ set(want)
    for k in want:
        a, b = got[k].cpu().numpy(), np.asarray(want[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)


# -- the hypercross kernel maps -----------------------------------------------

@pytest.mark.parametrize("k,dim", [(3, 3), (5, 3), (7, 3), (3, 6)])
def test_hypercross_offsets(k, dim):
    for stride in (1, 4):
        got = kernel_map.hypercross_offsets(k, dim, stride)
        np.testing.assert_array_equal(got, jkm.hypercross_offsets(k, dim,
                                                                  stride))
        assert got.dtype == np.int32 and len(got) == 1 + (k // 2) * 2 * dim
    with pytest.raises(ValueError, match="kernel region"):
        kernel_map.region_offsets("sphere")


@pytest.mark.parametrize("dim,conv1", [(3, 3), (3, 5), (6, 3)])
def test_hypercross_pyramids_equal_gmf_tpu(dim, conv1):
    """Host (native and NumPy builders) and device pyramids with
    region="hypercross" equal gmf_tpu's build_pyramid arrays bit for bit."""
    c = _coords(1, dim, 200, 10 if dim == 3 else 5)
    kw = dict(conv1_kernel_size=conv1, granule=64)
    want = jax_arrays(jkm.build_pyramid(c, 4, region="hypercross", **kw))
    for builder in ("native", "numpy"):
        pyr = kernel_map.build_pyramid(c, 4, builder=builder,
                                       region="hypercross", **kw)
        assert pyr.conv1_volume == 1 + (conv1 // 2) * 2 * dim
        _assert_arrays_equal(pyramid_to_arrays(pyr, "cpu"), want)
    dev = build_pyramid_arrays_device(c, 4, device="cpu",
                                      region="hypercross", **kw)
    assert dev["conv1_volume"] == 1 + (conv1 // 2) * 2 * dim
    _assert_arrays_equal(dev, want)


# -- the sparse zoo -------------------------------------------------------------

NARROW6 = dict(channels=(4, 8, 8, 16, 16, 16),
               tr_channels=(8, 8, 16, 16, 16, 16))
# name: (gmf_tpu class, port class, settings, levels, region, bridge),
# each a narrow net of the registry preset's structure
ZOO = {
    "ResUNetBN2CX": (JaxResUNet, SparseResUNet2, dict(
        channels=(4, 8, 16, 32), tr_channels=(8, 8, 8, 16),
        region="hypercross", conv1_kernel_size=5, normalize_feature=True),
        4, "hypercross", sparse_resunet_to_state_dict),
    "SimpleNetBN2C": (JaxSimpleNet, SimpleSparseUNet, dict(
        channels=(4, 8, 16), tr_channels=(8, 8, 8), normalize_feature=True),
        4, "hypercube", sparse_zoo_to_state_dict),
    "PyramidNet": (JaxPyramidNet, SparsePyramidNet, dict(
        channels=(4, 8, 16, 16), tr_channels=(8, 16, 16, 16),
        depths=(1,) * 4), 4, "hypercube", sparse_zoo_to_state_dict),
    "PyramidNet6INBN": (JaxPyramidNet, SparsePyramidNet, dict(
        **NARROW6, depths=(1,) * 6, norm="inbn", normalize_feature=True),
        6, "hypercube", sparse_zoo_to_state_dict),
    "PyramidNet6NoBlock": (JaxPyramidNet, SparsePyramidNet, dict(
        **NARROW6, depths=(0,) * 6), 6, "hypercube",
        sparse_zoo_to_state_dict),
}


@pytest.mark.parametrize("name", sorted(ZOO))
def test_zoo_net_matches_gmf_tpu(name):
    """Eval-mode forward on host maps against gmf_tpu's apply (1e-5), the
    padded rows zero, and the same output on device-built maps."""
    jax_cls, cls, kw, levels, region, bridge = ZOO[name]
    kw = dict(in_channels=1, out_channels=8, **kw)
    c = _coords(2)
    pk = dict(conv1_kernel_size=kw.get("conv1_kernel_size", 3), granule=64,
              region=region)
    want_maps = jax_arrays(jkm.build_pyramid(c, levels, **pk))
    arrays = pyramid_to_arrays(kernel_map.build_pyramid(c, levels, **pk),
                               "cpu")
    n, cap = len(c), arrays["mask_0"].shape[0]
    feats = np.random.RandomState(3).randn(cap, 1).astype(np.float32)
    feats[n:] = 0
    jm = jax_cls(**kw)
    v = _random_variables(jm, 4, jnp.asarray(feats), want_maps)
    ref = np.asarray(jax.jit(jm.apply)(v, jnp.asarray(feats), want_maps))
    net = cls(**kw).eval()
    net.load_state_dict(bridge(v), strict=True)
    with torch.no_grad():
        got = net(torch.from_numpy(feats), arrays).numpy()
        dev = net(torch.from_numpy(feats), build_pyramid_arrays_device(
            c, levels, device="cpu", **pk)).numpy()
    _close(got, ref, 1e-5)
    assert np.abs(ref[:n]).max() > 0.1 and not got[n:].any()
    np.testing.assert_array_equal(dev, got)


def test_zoo_net_refuses_another_regions_pyramid():
    c = _coords(5, n=120, extent=12)
    net = SparseResUNet2(in_channels=1, out_channels=8, region="hypercross",
                         channels=(4, 8, 16, 32), tr_channels=(8, 8, 8, 16))
    cube = pyramid_to_arrays(kernel_map.build_pyramid(c, 4, granule=64),
                             "cpu")
    with pytest.raises(ValueError, match="region"):
        net(torch.ones(cube["mask_0"].shape[0], 1), cube)
    with pytest.raises(ValueError, match="norm"):
        SparsePyramidNet(norm="ln")


# -- the correspondence blocks and OANet ------------------------------------------

def _tokens(seed, b=2, n=60, c=6):
    return np.random.RandomState(seed).randn(b, n, c).astype(np.float32)


def _linear_sd(p):
    sd = {"weight": torch.from_numpy(np.asarray(p["kernel"]).T.copy())}
    if "bias" in p:
        sd["bias"] = torch.from_numpy(np.asarray(p["bias"]).copy())
    return sd


@pytest.mark.parametrize("block", ["norms", "edgeconv", "pointcn_post",
                                   "pointcn_pre"])
def test_blocks_match_gmf_tpu(block):
    """Inputs from a Gaussian seed, so no two kNN distances tie."""
    x = _tokens(6, c=8)
    xt = torch.from_numpy(x)
    if block == "norms":
        _close(blocks.instance_norm_tokens(xt).numpy(),
               jblocks.instance_norm_tokens(jnp.asarray(x)), 1e-5)
        _close(blocks.ContextNormalization()(xt).numpy(),
               jblocks.ContextNormalization().apply({}, jnp.asarray(x)), 1e-5)
        return
    if block == "edgeconv":
        jm = jblocks.EdgeConv(out_dim=12, k=5)
        v = _random_variables(jm, 7, jnp.asarray(x))
        m = blocks.EdgeConv(8, 12, k=5)
        m.conv.load_state_dict(_linear_sd(v["params"]["conv"]))
        with torch.no_grad():
            _close(m(xt).numpy(), jm.apply(v, jnp.asarray(x)), 1e-5)
        return
    act = block.split("_")[1]
    jm = jblocks.PointCN(num_layers=2, num_channels=16, act_pos=act)
    v = _random_variables(jm, 8, jnp.asarray(x))
    m = blocks.PointCN(8, num_layers=2, num_channels=16, act_pos=act)
    sd = {f"layer0.{k}": t for k, t in
          _linear_sd(v["params"]["layer0"]).items()}
    for i in range(2):
        sd.update({f"conv_{i}.{k}": t for k, t in
                   _linear_sd(v["params"][f"conv_{i}"]).items()})
        bn, st = v["params"][f"bn_{i}"], v["batch_stats"][f"bn_{i}"]
        for k, a in (("weight", bn["scale"]), ("bias", bn["bias"]),
                     ("running_mean", st["mean"]),
                     ("running_var", st["var"])):
            sd[f"bn_{i}.{k}"] = torch.from_numpy(np.asarray(a).copy())
        sd[f"bn_{i}.num_batches_tracked"] = torch.tensor(0)
    m.load_state_dict(sd, strict=True)
    with torch.no_grad():
        _close(m.eval()(xt).numpy(), jm.apply(v, jnp.asarray(x)), 1e-5)


OANET = dict(num_layers=4, num_channels=16, num_clusters=5)


def _reference_oanet_state_dict(seed=9):
    """A synthetic reference OANet state_dict: the reference's names, its
    k=1 Conv1d weights [out, in, 1], statistics away from their init."""
    r = np.random.RandomState(seed)
    sd = {}
    for k, v in OANet(**OANET).state_dict().items():
        if k.endswith("num_batches_tracked"):
            sd[k] = v
            continue
        if k.endswith("running_var"):
            x = 0.5 + r.rand(*v.shape)
        elif v.dim() == 2:
            x = (r.randn(*v.shape) / np.sqrt(v.shape[1]))[..., None]
        else:
            x = 0.1 * r.randn(*v.shape) + ("weight" in k)
        sd[k] = torch.tensor(x, dtype=torch.float32)
    return sd


@pytest.fixture(scope="module")
def oanet_pair():
    sd = _reference_oanet_state_dict()
    jv = jct.convert_oanet({k: v.numpy() for k, v in sd.items()},
                           num_layers=OANET["num_layers"])
    return sd, jv


def test_oanet_matches_gmf_tpu(oanet_pair):
    """A reference state_dict through each package's converter: features
    and logits at 1e-5, then one train-mode forward and its updated
    running statistics; the bridge gives the converter's weights."""
    sd, jv = oanet_pair
    x = _tokens(10)
    jm = JaxOANet(**OANET)
    net = OANet(**OANET).eval()
    net.load_state_dict(convert_torch.convert_oanet(sd, OANET["num_layers"]),
                        strict=True)
    for logits in (False, True):
        ref = jm.apply(jv, jnp.asarray(x), return_logits=logits)
        with torch.no_grad():
            got = net(torch.from_numpy(x), return_logits=logits)
        assert got.shape == (2, 60) if logits else (2, 60, 16)
        _close(got.numpy(), ref, 1e-5)
    bridged = oanet_to_state_dict(jax.tree.map(np.asarray, jv),
                                  OANET["num_layers"])
    assert set(bridged) == set(net.state_dict())
    for k, t in net.state_dict().items():
        np.testing.assert_array_equal(bridged[k].numpy(), t.numpy(),
                                      err_msg=k)
    ref, new = jm.apply(jv, jnp.asarray(x), train=True,
                        mutable=["batch_stats"])
    with torch.no_grad():
        got = net.train()(torch.from_numpy(x))
    _close(got.numpy(), ref, 1e-5)
    stats = oanet_to_state_dict(
        {"params": jv["params"],
         "batch_stats": jax.tree.map(np.asarray, new["batch_stats"])},
        OANET["num_layers"])
    for k, t in net.state_dict().items():
        if "running" in k:
            _close(t.numpy(), stats[k].numpy(), 1e-5)


# -- the registry --------------------------------------------------------------

def test_registry_names_equal_gmf_tpu():
    assert sorted(MODELS) == sorted(JAX_MODELS) and len(MODELS) == 15
    with pytest.raises(KeyError, match="ResUNetBN2C"):
        load_model("ResUNetBN3")
    net = load_model("ResUNetBN2CX")(conv1_kernel_size=7)
    assert net.region == "hypercross" and net.conv1_volume == 19
    assert net.conv2.kernel.shape == (7, 32, 64)
    pyr = load_model("PyramidNet8INBN")(in_channels=1)
    assert pyr.levels == 8 and pyr.instance_norm is not None
    assert load_model("OANet")().output.weight.shape == (1, 128)


# -- the converters ----------------------------------------------------------------

@pytest.mark.parametrize("k,dim", [(3, 3), (5, 3), (7, 3), (3, 6)])
def test_me_offset_permutation(k, dim):
    for fastest in ("first", "last"):
        got = convert_minkowski.me_offset_permutation(k, dim, fastest)
        np.testing.assert_array_equal(
            got, jcm.me_offset_permutation(k, dim, fastest))
    assert sorted(got) == list(range(k ** dim))


NARROW4 = dict(channels=(4, 8, 16, 32), tr_channels=(8, 8, 8, 16))


@pytest.mark.parametrize("fusion", [False, True])
def test_convert_sparse_resunet_equals_gmf_tpu(fusion):
    """A synthetic ME-layout state_dict (the port net's names and shapes,
    random values, kernels read as ME's offset order) through the port's
    converter equals gmf_tpu's converter followed by the bridge."""
    r = np.random.RandomState(11)
    kw = dict(in_channels=1, out_channels=1 if fusion else 8,
              dim=6 if fusion else 3, conv1_kernel_size=3 if fusion else 5,
              with_gmf_fusion=fusion, **NARROW4)
    if fusion:
        kw["image_dim"] = 16
    sd = {}
    for k, v in SparseResUNet2(**kw).state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        x = r.randn(*v.shape) if v.dim() else r.randn()
        if k.endswith("running_var"):
            x = 0.5 + r.rand(*v.shape)
        sd[k] = x.astype(np.float32)
    args = dict(dim=kw["dim"], conv1_kernel_size=kw["conv1_kernel_size"],
                with_gmf_fusion=fusion)
    got = convert_minkowski.convert_sparse_resunet(sd, **args)
    want = sparse_resunet_to_state_dict(jcm.convert_sparse_resunet(sd,
                                                                   **args))
    assert set(got) == set(want), set(got) ^ set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(),
                                      err_msg=k)
    SparseResUNet2(**kw).load_state_dict(got, strict=True)
    perm = convert_minkowski.me_offset_permutation(kw["conv1_kernel_size"],
                                                   kw["dim"])
    np.testing.assert_array_equal(got["conv1.kernel"].numpy(),
                                  sd["conv1.kernel"][perm])


def _reference_part(module, prefix, seed):
    """A reference state_dict of one part: ``module``'s names and shapes
    under ``prefix``, random values (positive running variances, no
    batches tracked), plus a key of another part."""
    r = np.random.RandomState(seed)
    sd = {"other.weight": torch.zeros(3)}
    for k, v in module.state_dict().items():
        if k.endswith("num_batches_tracked"):
            sd[prefix + k] = torch.zeros_like(v)
            continue
        x = 0.5 + r.rand(*v.shape) if k.endswith("running_var") else \
            r.randn(*v.shape)
        sd[prefix + k] = torch.tensor(x, dtype=torch.float32)
    return sd


@pytest.mark.parametrize("part", ["resnet_trunk", "image_encoder",
                                  "fusion_layer", "fusion_layer_pe_depth"])
def test_convert_part_equals_gmf_tpu(part):
    """Each part's converter equals gmf_tpu's followed by the bridge, in
    every bit, and loads into the port's module strictly."""
    from gmf_tpu_torch.nn.fusion import FusionLayer
    from gmf_tpu_torch.nn.resnet import ImageEncoder, ResNet
    from gmf_tpu_torch.utils import bridge

    if part == "resnet_trunk":
        module, prefix = ResNet(base_width=8), "resnet."
        sd = _reference_part(module, prefix, 1)
        # torchvision's later stages, which the trunk leaves out
        sd[prefix + "layer3.0.conv1.weight"] = torch.zeros(2, 2, 3, 3)
        got = convert_torch.convert_resnet_trunk(sd, prefix)
        p, s = jct.convert_resnet_trunk(
            {k: v.numpy() for k, v in sd.items()}, prefix)
        want = {}
        bridge._resnet_trunk(want, "", p, s)
    elif part == "image_encoder":
        module, prefix = ImageEncoder(base_width=8), "encoder.image_encoder."
        sd = _reference_part(module, prefix, 2)
        got = convert_torch.convert_image_encoder(sd, prefix)
        p, s = jct.convert_image_encoder(
            {k: v.numpy() for k, v in sd.items()}, prefix)
        want = bridge.image_encoder_to_state_dict(p, s)
    else:
        pe = part.endswith("depth")
        depth = 2 if pe else 0
        module = FusionLayer(dim=12, latent_dim=20, depth=depth,
                             cross_heads=2, cross_dim_head=5, latent_heads=3,
                             latent_dim_head=4, pe=pe,
                             out_to_context_dim=not pe)
        prefix = "encoder.fusion_layer_1."
        sd = _reference_part(module, prefix, 3)
        got = convert_torch.convert_fusion_layer(sd, prefix, pe=pe,
                                                 depth=depth)
        want = bridge.fusion_layer_to_state_dict(jct.convert_fusion_layer(
            {k: v.numpy() for k, v in sd.items()}, prefix, pe=pe,
            depth=depth))
    assert set(got) == set(want), set(got) ^ set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(),
                                      err_msg=k)
    module.load_state_dict(got, strict=True)


def test_convert_cli_round_trip_and_print(oanet_pair, tmp_path, capsys):
    """The convert CLI writes an OANet directory that load_oanet reads
    back to the converter's weights and load_pointdsc refuses; a PointDSC
    file converts and loads; print_checkpoint reads both kinds."""
    sd, _ = oanet_pair
    src = str(tmp_path / "oanet.pth")
    torch.save(sd, src)
    out = convert_torch.main(["--input", src, "--out",
                              str(tmp_path / "oanet"), "--model", "oanet",
                              "--num-layers", str(OANET["num_layers"])])
    loaded = model_io.load_oanet(out, device="cpu")
    assert loaded.config == dict(in_dim=6, **OANET)
    direct = convert_torch.convert_oanet(sd, OANET["num_layers"])
    for k, t in loaded.state_dict().items():
        np.testing.assert_array_equal(t.numpy(), direct[k].numpy(),
                                      err_msg=k)
    from_file = model_io.load_oanet(src, num_layers=OANET["num_layers"],
                                    device="cpu")
    assert from_file.config == loaded.config
    with pytest.raises(ValueError, match="oanet"):
        model_io.load_pointdsc(out, device="cpu")

    from gmf_tpu_torch.models import PointDSC

    tiny = dict(num_layers=1, num_channels=16, k=10)
    ref_pd = {k: (v[..., None] if v.dim() == 2 and "encoder.image" not in k
                  and "fusion" not in k else v)
              for k, v in PointDSC(device="cpu", **tiny).state_dict().items()}
    pd_src = str(tmp_path / "model_best.pkl")
    torch.save(ref_pd, pd_src)
    pd_out = convert_torch.main(["--input", pd_src, "--out",
                                 str(tmp_path / "pd"), "--num-layers", "1"])
    pd = model_io.load_pointdsc(pd_out, device="cpu")
    assert pd.config["num_channels"] == 16
    with pytest.raises(ValueError, match="pointdsc"):
        model_io.load_oanet(pd_out, device="cpu")

    capsys.readouterr()
    n_dir, total = print_checkpoint.main([out])
    text = capsys.readouterr().out
    assert "'arch': 'oanet'" in text and "l1_1.0.weight: (16, 6)" in text
    n_file, total_file = print_checkpoint.main([src, "--max-leaves", "3"])
    text = capsys.readouterr().out
    assert "l1_1.0.weight: (16, 6, 1)" in text
    assert text.count(": (") == 3
    assert (n_dir, total) == (n_file, total_file) == (
        len(sd), sum(v.numel() for v in sd.values()))
    assert os.path.exists(os.path.join(out, "config.json"))
