"""gmf_tpu_torch.sparse (voxelize, kernel maps, convolution, ResUNets) and
the DGR fusion variant vs gmf_tpu on the same inputs (CPU, f32).

Widths are gmf_tpu's DGR test widths (tests/test_dgr.py:85-92: channels
4/8/16/32, TR 8/8/8/16, image_dim 16, granules 256); inputs come from
numpy seeds and weights cross by utils/bridge.py. Tolerances:
- quantization and every kernel-map array: equal in every bit (native
  builder, NumPy builder and gmf_tpu.sparse.kernel_map.build_pyramid);
- convolutions and norms: 1e-5 of the output's largest entry (ATen and
  XLA:CPU sum the K x Cin products in different orders);
- whole nets: 1e-4 of the output's largest entry (17 convolutions, two
  fusion layers and the image encoder compound those orders);
- the golden: gmf_tpu's own tolerance there, 2e-4.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gmf_tpu.nn.fusion import Attention as JaxAttention
from gmf_tpu.nn.fusion import FusionLayer as JaxFusionLayer
from gmf_tpu.sparse import conv as jconv
from gmf_tpu.sparse.kernel_map import build_pyramid as jax_build_pyramid
from gmf_tpu.sparse.resunet import SparseResUNet2 as JaxSparseResUNet2
from gmf_tpu.sparse.resunet import pyramid_to_arrays as jax_arrays
from gmf_tpu.sparse.voxelize import sparse_quantize as jax_quantize
from gmf_tpu_torch.nn.fusion import Attention, FusionLayer
from gmf_tpu_torch.sparse import kernel_map
from gmf_tpu_torch.sparse.conv import (MaskedBatchNorm, MaskedInstanceNorm,
                                       SparseConv, append_sentinel,
                                       sparse_conv)
from gmf_tpu_torch.sparse.kernel_map import build_kernel_map, build_pyramid
from gmf_tpu_torch.sparse.resunet import SparseResUNet2, pyramid_to_arrays
from gmf_tpu_torch.sparse.voxelize import sparse_quantize
from gmf_tpu_torch.utils.bridge import (fusion_layer_to_state_dict,
                                        sparse_resunet_to_state_dict)

torch.set_num_threads(2)
NARROW = dict(channels=(4, 8, 16, 32), tr_channels=(8, 8, 8, 16))
GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "sparse_resunet.npz")


def _close(got, ref, rtol):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref,
                               atol=rtol * max(np.abs(ref).max(), 1e-30))


def _coords(seed, dim, n, extent):
    r = np.random.RandomState(seed)
    return np.unique(r.randint(0, extent, (n, dim)).astype(np.int32), axis=0)


def _pyramid_fields(p):
    out = {"conv1_map": p.conv1_map, "conv1_kept": p.conv1_kept}
    for l, lv in enumerate(p.levels):
        for name in ("coords", "self_map", "self_kept", "down_map",
                     "down_kept", "up_map", "up_kept"):
            if getattr(lv, name) is not None:
                out[f"{name}_{l}"] = getattr(lv, name)
        out[f"num_valid_{l}"] = np.asarray(lv.num_valid)
    return out


@pytest.mark.parametrize("dim,voxel", [(3, 0.05), (6, 1.0)])
def test_quantize_equals_gmf_tpu(dim, voxel):
    r = np.random.RandomState(dim)
    pts = (r.rand(900, dim) * 2.0).astype(np.float32)
    if dim == 6:
        pts = np.floor(pts * 4).astype(np.float64)  # repeated 6-D coords
    got = sparse_quantize(pts, voxel, return_index=True, return_inverse=True)
    ref = jax_quantize(pts, voxel, return_index=True, return_inverse=True)
    for g, w in zip(got, ref):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("dim,conv1,extent", [(3, 7, 10), (3, 5, 10),
                                               (3, 3, 10), (6, 3, 5)])
def test_pyramid_bits_native_numpy_gmf_tpu(dim, conv1, extent):
    """Every array of the pyramid, 3-D and pruned 6-D, in every bit."""
    c = _coords(dim, dim, 150, extent)
    before = kernel_map.BUILDS["native"]
    native = build_pyramid(c, 4, conv1_kernel_size=conv1, granule=256)
    assert kernel_map.BUILDS["native"] - before == 11  # 4 self, 3+3, conv1
    plain = build_pyramid(c, 4, conv1_kernel_size=conv1, granule=256,
                          builder="numpy")
    ref = jax_build_pyramid(c, 4, conv1_kernel_size=conv1, granule=256)
    fields = [_pyramid_fields(p) for p in (native, plain, ref)]
    assert fields[0].keys() == fields[2].keys()
    for key, want in fields[2].items():
        for got in fields[:2]:
            assert got[key].dtype == want.dtype, key
            np.testing.assert_array_equal(got[key], want, err_msg=key)
    if dim == 6:  # pruned to a multiple of 32 of the 729 offsets
        assert native.levels[0].self_map.shape[0] % 32 == 0
        assert native.levels[0].self_map.shape[0] < 729


def test_kernel_map_builder_by_name_and_failed_build_raises(tmp_path,
                                                            monkeypatch):
    c = _coords(0, 3, 40, 6)
    off = kernel_map.hypercube_offsets(3, 3)
    with pytest.raises(ValueError, match="unknown kernel-map builder"):
        build_kernel_map(c, c, off, builder="auto")
    bad = tmp_path / "kernel_map.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(kernel_map, "SOURCE", bad)
    monkeypatch.setattr(kernel_map, "_LIB", None)
    with pytest.raises(RuntimeError, match="failed"):
        build_kernel_map(c, c, off)
    # the NumPy path only by name, and it still works
    nbr, kept = build_kernel_map(c, c, off, builder="numpy")
    assert nbr.shape == (27, len(c)) and np.array_equal(kept, np.arange(27))


@pytest.mark.parametrize("dim,which", [(3, "conv1"), (3, "up_map_0"),
                                       (6, "self_map_0"), (6, "down_map_1")])
def test_sparse_conv(dim, which):
    c = _coords(1, dim, 120, 8 if dim == 3 else 4)
    conv1 = 7 if dim == 3 else 3
    pyr = build_pyramid(c, 4, conv1_kernel_size=conv1, granule=256)
    arrays = pyramid_to_arrays(pyr, "cpu")
    nbr = arrays["conv1_map" if which == "conv1" else which].numpy()
    kept = arrays["conv1_kept" if which == "conv1"
                  else which.replace("_map_", "_kept_")].numpy()
    src_level = {"conv1": 0, "up_map_0": 1, "self_map_0": 0,
                 "down_map_1": 1}[which]
    cap_in = pyr.levels[src_level].cap
    r = np.random.RandomState(2)
    cin, cout = 6, 5
    x = r.randn(cap_in, cin).astype(np.float32)
    w = r.randn(int(kept.max()) + 1, cin, cout).astype(np.float32)
    ref = jconv.sparse_conv(jconv.append_sentinel(jnp.asarray(x)),
                            jnp.asarray(w)[kept], jnp.asarray(nbr))
    got = sparse_conv(append_sentinel(torch.from_numpy(x)),
                      torch.from_numpy(w)[torch.from_numpy(kept).long()],
                      torch.from_numpy(nbr))
    assert got.shape == ref.shape
    _close(got.numpy(), ref, 1e-5)
    # the module selects its kernel rows by the kept ids
    mod = SparseConv(cin, cout, w.shape[0])
    with torch.no_grad():
        mod.kernel.copy_(torch.from_numpy(w))
        got2 = mod(append_sentinel(torch.from_numpy(x)),
                   torch.from_numpy(nbr), torch.from_numpy(kept))
    _close(got2.numpy(), ref, 1e-5)


def test_masked_norms():
    r = np.random.RandomState(3)
    x = r.randn(40, 6).astype(np.float32)
    mask = (np.arange(40) < 29).astype(np.float32)
    jbn = jconv.MaskedBatchNorm()
    v = jbn.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(mask))
    v = {"params": {"scale": r.rand(6).astype(np.float32) + 0.5,
                    "bias": r.randn(6).astype(np.float32)},
         "batch_stats": {"mean": r.randn(6).astype(np.float32),
                         "var": r.rand(6).astype(np.float32) + 0.5}}
    ref = jbn.apply(v, jnp.asarray(x), jnp.asarray(mask))
    bn = MaskedBatchNorm(6).eval()
    with torch.no_grad():
        bn.bn.weight.copy_(torch.from_numpy(v["params"]["scale"]))
        bn.bn.bias.copy_(torch.from_numpy(v["params"]["bias"]))
        bn.bn.running_mean.copy_(torch.from_numpy(v["batch_stats"]["mean"]))
        bn.bn.running_var.copy_(torch.from_numpy(v["batch_stats"]["var"]))
        got = bn(torch.from_numpy(x), torch.from_numpy(mask))
    _close(got.numpy(), ref, 1e-6)
    assert not got[29:].any()  # padded rows multiplied to zero
    # train mode: the masked batch statistics and flax's running update
    ref_tr, new = jbn.apply(v, jnp.asarray(x), jnp.asarray(mask), train=True,
                            mutable=["batch_stats"])
    with torch.no_grad():
        got_tr = bn.train()(torch.from_numpy(x), torch.from_numpy(mask))
    _close(got_tr.numpy(), ref_tr, 1e-5)
    assert not got_tr[29:].any()
    _close(bn.bn.running_mean.numpy(), new["batch_stats"]["mean"], 1e-6)
    _close(bn.bn.running_var.numpy(), new["batch_stats"]["var"], 1e-6)
    ref_in = jconv.MaskedInstanceNorm().apply({}, jnp.asarray(x),
                                              jnp.asarray(mask))
    got_in = MaskedInstanceNorm()(torch.from_numpy(x), torch.from_numpy(mask))
    _close(got_in.numpy(), ref_in, 1e-5)


@pytest.mark.parametrize("builder", ["native", "numpy"])
@pytest.mark.parametrize("prune", [False, True])
def test_build_kernel_map_in_valid(builder, prune):
    """``in_valid`` (the sentinel of a padded input capacity) gives
    gmf_tpu's arrays in every bit, from either builder."""
    from gmf_tpu.sparse.kernel_map import build_kernel_map as jax_map

    c = _coords(4, 3, 60, 6)
    out = c[::2]
    off = kernel_map.hypercube_offsets(3, 3)
    cap = len(c) + 9
    nbr, kept = build_kernel_map(c, out, off, prune_empty=prune,
                                 in_valid=cap, builder=builder)
    jnbr, jkept = jax_map(c, out, off, prune_empty=prune, in_valid=cap)
    np.testing.assert_array_equal(nbr, jnbr)
    np.testing.assert_array_equal(kept, jkept)
    assert (nbr == cap).any() and not (nbr == len(c)).any()


def test_conv_bias_and_norm_parameters():
    """SparseConv(use_bias=True), MaskedBatchNorm(momentum=, epsilon=) in
    train mode and MaskedInstanceNorm(epsilon=) against gmf_tpu's, 1e-5
    of the largest entry (1e-6 for the running statistics); ``eps``, the
    port's earlier name, is the same setting."""
    r = np.random.RandomState(5)
    c = _coords(1, 3, 120, 8)
    pyr = build_pyramid(c, 4, conv1_kernel_size=3, granule=256)
    arrays = pyramid_to_arrays(pyr, "cpu")
    nbr, kept = arrays["self_map_0"], arrays["self_kept_0"]
    x = r.randn(pyr.levels[0].cap, 6).astype(np.float32)
    w = r.randn(27, 6, 4).astype(np.float32)
    b = r.randn(4).astype(np.float32)
    ref = jconv.SparseConv(4, 27, use_bias=True).apply(
        {"params": {"kernel": w, "bias": b}},
        jconv.append_sentinel(jnp.asarray(x)), jnp.asarray(nbr.numpy()),
        jnp.asarray(kept.numpy()))
    mod = SparseConv(6, 4, 27, use_bias=True)
    assert set(mod.state_dict()) == {"kernel", "bias"}
    mod.load_state_dict({"kernel": torch.tensor(w), "bias": torch.tensor(b)})
    with torch.no_grad():
        got = mod(append_sentinel(torch.tensor(x)), nbr, kept)
    _close(got.numpy(), ref, 1e-5)

    x = r.randn(40, 6).astype(np.float32)
    mask = (np.arange(40) < 31).astype(np.float32)
    v = {"params": {"scale": r.rand(6).astype(np.float32) + 0.5,
                    "bias": r.randn(6).astype(np.float32)},
         "batch_stats": {"mean": r.randn(6).astype(np.float32),
                         "var": r.rand(6).astype(np.float32) + 0.5}}
    jbn = jconv.MaskedBatchNorm(momentum=0.7, epsilon=1e-2)
    ref, new = jbn.apply(v, jnp.asarray(x), jnp.asarray(mask), train=True,
                         mutable=["batch_stats"])
    for bn in (MaskedBatchNorm(6, momentum=0.7, epsilon=1e-2),
               MaskedBatchNorm(6, momentum=0.7, eps=1e-2)):
        with torch.no_grad():
            bn.bn.weight.copy_(torch.from_numpy(v["params"]["scale"]))
            bn.bn.bias.copy_(torch.from_numpy(v["params"]["bias"]))
            bn.bn.running_mean.copy_(
                torch.from_numpy(v["batch_stats"]["mean"]))
            bn.bn.running_var.copy_(torch.from_numpy(v["batch_stats"]["var"]))
            got = bn.train()(torch.from_numpy(x), torch.from_numpy(mask))
        _close(got.numpy(), ref, 1e-5)
        _close(bn.bn.running_mean.numpy(), new["batch_stats"]["mean"], 1e-6)
        _close(bn.bn.running_var.numpy(), new["batch_stats"]["var"], 1e-6)
    ref_in = jconv.MaskedInstanceNorm(epsilon=0.5).apply(
        {}, jnp.asarray(x), jnp.asarray(mask))
    for norm in (MaskedInstanceNorm(epsilon=0.5), MaskedInstanceNorm(eps=0.5)):
        got_in = norm(torch.from_numpy(x), torch.from_numpy(mask))
        _close(got_in.numpy(), ref_in, 1e-5)


@pytest.mark.parametrize("module", ["attention", "fusion_pe"])
def test_dgr_attention_maps_to_query_width(module):
    """out_to_context_dim=False: 24-wide queries into 16-wide context."""
    r = np.random.RandomState(4)
    x = r.randn(1, 30, 24).astype(np.float32)
    ctx = r.randn(1, 11, 16).astype(np.float32)
    if module == "attention":
        jm = JaxAttention(query_dim=24, context_dim=16, heads=1, dim_head=8,
                          out_to_context_dim=False)
        params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x),
                         context=jnp.asarray(ctx))["params"]
        ref = jm.apply({"params": params}, jnp.asarray(x),
                       context=jnp.asarray(ctx))
        tm = Attention(24, 16, heads=1, dim_head=8, out_to_context_dim=False)
        sd = {f"{n}.weight": torch.from_numpy(
            np.asarray(params[n]["kernel"]).T.copy())
            for n in ("to_q", "to_kv", "to_out")}
        sd["to_out.bias"] = torch.tensor(
            np.asarray(params["to_out"]["bias"]))
        tm.load_state_dict(sd, strict=True)
        with torch.no_grad():
            got = tm(torch.from_numpy(x), context=torch.from_numpy(ctx))
    else:
        jm = JaxFusionLayer(dim=16, latent_dim=24, depth=0, cross_heads=1,
                            cross_dim_head=12, pe=True,
                            out_to_context_dim=False)
        params = jm.init(jax.random.PRNGKey(1), jnp.asarray(ctx),
                         queries_encoder=jnp.asarray(x))["params"]
        ref = jm.apply({"params": params}, jnp.asarray(ctx),
                       queries_encoder=jnp.asarray(x))
        tm = FusionLayer(dim=16, latent_dim=24, cross_heads=1,
                         cross_dim_head=12, pe=True, out_to_context_dim=False)
        tm.load_state_dict(fusion_layer_to_state_dict(params), strict=True)
        with torch.no_grad():
            got = tm(torch.from_numpy(ctx), queries_encoder=torch.from_numpy(x))
    assert got.shape == (1, 30, 24)
    _close(got.numpy(), ref, 1e-5)


def _jax_net(kw, feats, arrays, images, seed=0):
    jm = JaxSparseResUNet2(**kw)
    v = jax.jit(jm.init)(jax.random.PRNGKey(seed), jnp.asarray(feats),
                         arrays, **images)
    r = np.random.RandomState(seed + 10)
    # non-trivial batch statistics everywhere (init leaves 0 and 1)
    v = {"params": jax.tree.map(np.asarray, v["params"]),
         "batch_stats": jax.tree_util.tree_map_with_path(
             lambda path, a: (np.asarray(a) + 0.3 * r.rand(*np.shape(a))
                              ).astype(np.float32), v["batch_stats"])}
    return jm, v


NETS = {
    "fcgf": dict(in_channels=1, out_channels=8, dim=3, conv1_kernel_size=7,
                 normalize_feature=True, **NARROW),
    "inlier6d": dict(in_channels=1, out_channels=1, dim=6,
                     conv1_kernel_size=3, with_gmf_fusion=True, image_dim=16,
                     **NARROW),
}


@pytest.mark.parametrize("name", list(NETS))
def test_resunet_against_gmf_tpu_and_padding(name):
    kw = NETS[name]
    dim = kw["dim"]
    c = _coords(5, dim, 140, 9 if dim == 3 else 4)
    r = np.random.RandomState(6)
    images = {}
    if kw.get("with_gmf_fusion"):
        images = {k: r.rand(1, 16, 16, 3).astype(np.float32)
                  for k in ("p_image", "q_image")}
    pyr = jax_build_pyramid(c, 4, conv1_kernel_size=kw["conv1_kernel_size"],
                            granule=256)
    feats = r.rand(pyr.levels[0].cap, 1).astype(np.float32)
    jm, v = _jax_net(kw, feats, jax_arrays(pyr), images)
    ref = np.asarray(jax.jit(jm.apply)(v, jnp.asarray(feats),
                                       jax_arrays(pyr), **images))
    tm = SparseResUNet2(**kw).eval()
    tm.load_state_dict(sparse_resunet_to_state_dict(v), strict=True)
    timg = {k: torch.from_numpy(a) for k, a in images.items()}
    with torch.no_grad():
        got = tm(torch.from_numpy(feats), pyramid_to_arrays(
            build_pyramid(c, 4, conv1_kernel_size=kw["conv1_kernel_size"],
                          granule=256), "cpu"), **timg).numpy()
        # padding invariance: larger capacities change no valid row, and
        # the padded rows stay zero
        big = build_pyramid(c, 4, conv1_kernel_size=kw["conv1_kernel_size"],
                            granule=512)
        feats_big = np.ones((big.levels[0].cap, 1), np.float32)
        feats_big[:len(feats)] = feats
        got_big = tm(torch.from_numpy(feats_big),
                     pyramid_to_arrays(big, "cpu"), **timg).numpy()
    _close(got, ref, 1e-4)
    n = len(c)
    _close(got_big[:n], got[:n], 1e-5)
    assert not got_big[n:].any() and not got[n:].any()


def test_resunet_golden():
    """gmf_tpu's frozen SparseResUNet2 output (tests/test_golden.py:58-71),
    by the port on the same weights."""
    rng = np.random.RandomState(51)
    coords = np.unique(rng.randint(0, 8, (60, 3)).astype(np.int32), axis=0)
    pyr = jax_build_pyramid(coords, 4, conv1_kernel_size=3, granule=64)
    kw = dict(in_channels=1, out_channels=8, normalize_feature=True,
              **NARROW)
    feats = jnp.ones((pyr.levels[0].cap, 1))
    v = jax.jit(JaxSparseResUNet2(**kw).init)(jax.random.PRNGKey(3), feats,
                                              jax_arrays(pyr))
    tm = SparseResUNet2(**kw).eval()
    tm.load_state_dict(sparse_resunet_to_state_dict(
        jax.tree.map(np.asarray, v)), strict=True)
    with torch.no_grad():
        got = tm(torch.ones(pyr.levels[0].cap, 1), pyramid_to_arrays(
            build_pyramid(coords, 4, conv1_kernel_size=3, granule=64),
            "cpu"))
    np.testing.assert_allclose(got[:len(coords)].numpy(),
                               np.load(GOLDEN)["value"], atol=2e-4)


def test_conv1_map_must_match_the_net():
    c = _coords(7, 3, 50, 6)
    tm = SparseResUNet2(in_channels=1, out_channels=8, conv1_kernel_size=3,
                        **NARROW).eval()
    arrays = pyramid_to_arrays(build_pyramid(c, 4, conv1_kernel_size=7,
                                             granule=64), "cpu")
    with pytest.raises(ValueError, match="conv1"):
        tm(torch.ones(arrays["mask_0"].shape[0], 1), arrays)
