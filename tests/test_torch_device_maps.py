"""gmf_tpu_torch's device kernel maps (sparse/device_maps.py), compacted
schedules (sparse/compact.py) and compacted convolution vs gmf_tpu on the
same inputs (CPU, f32), and the DGR engine on them.

Clouds of ~150 voxels with extents 5-10; nets at gmf_tpu's DGR test
widths (channels 4/8/16/32, TR 8/8/8/16, image_dim 16), weights bridged
from flax (utils/bridge.py). Tolerances:
- kernel maps, pyramids and schedules: equal in every bit, to gmf_tpu's
  sorted probe, its device pyramid and its schedules, and to the port's
  host builder;
- one convolution: 1e-5 of the output's largest entry (the compacted sum
  adds the same products as the dense one in another order); its
  gradients likewise;
- a whole net: FCGF 1e-5 (unit rows), the inlier net 1e-4 of the
  output's largest entry (tests/test_torch_sparse.py says why);
- register: nn01 equal, weights within 1e-5, T within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gmf_tpu.sparse import compact as jcompact
from gmf_tpu.sparse import conv as jconv
from gmf_tpu.sparse.device_maps import \
    build_pyramid_arrays_device as jax_device_pyramid
from gmf_tpu.sparse.device_maps import device_kernel_map as jax_device_map
from gmf_tpu.sparse.kernel_map import build_pyramid as jax_build_pyramid
from gmf_tpu.sparse.resunet import SparseResUNet2 as JaxNet
from gmf_tpu.sparse.resunet import pyramid_to_arrays as jax_arrays
from gmf_tpu_torch.models import dgr
from gmf_tpu_torch.sparse import compact, kernel_map
from gmf_tpu_torch.sparse.conv import (SparseConv, append_sentinel,
                                       set_scatter_mode, sparse_conv,
                                       sparse_conv_compact,
                                       sparse_conv_compact_in_tile_order)
from gmf_tpu_torch.sparse.device_maps import (build_pyramid_arrays_device,
                                              device_kernel_map)
from gmf_tpu_torch.sparse.kernel_map import (build_kernel_map, build_pyramid,
                                             downsample_coords,
                                             hypercube_offsets)
from gmf_tpu_torch.sparse.resunet import (FCGFNet, SparseResUNet2,
                                          pyramid_to_arrays)
from gmf_tpu_torch.utils.bridge import sparse_resunet_to_state_dict

from test_torch_dgr import _engines, _jax_vars, _nets

torch.set_num_threads(2)
NARROW = dict(channels=(4, 8, 16, 32), tr_channels=(8, 8, 8, 16))


def _coords(seed, dim, n, extent, lo=0):
    r = np.random.RandomState(seed)
    return np.unique(r.randint(lo, lo + extent, (n, dim)).astype(np.int32),
                     axis=0)


def _assert_same(got, want, path=""):
    """Equal in every bit, key by key and leaf by leaf (dtype and shape
    too); ``got`` holds torch tensors, ``want`` JAX or NumPy arrays."""
    if isinstance(want, dict):
        assert set(got) == set(want), (path, set(got) ^ set(want))
        for k in want:
            _assert_same(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            _assert_same(a, b, f"{path}[{i}]")
    elif want is None:
        assert got is None, path
    else:
        a = got.cpu().numpy() if isinstance(got, torch.Tensor) else got
        b = np.asarray(want)
        assert a.dtype == b.dtype and a.shape == b.shape, (
            path, a.dtype, b.dtype, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=path)


def _close(got, ref, rtol):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref,
                               atol=rtol * max(np.abs(ref).max(), 1e-30))


def _map_case(case):
    """(in coords [N, D] padded, out coords [M, D], offsets, in mask, out
    mask, number of valid in / out rows, lattice) for one map."""
    if case in ("3d", "6d", "negative"):
        dim = 6 if case == "6d" else 3
        c = _coords(1, dim, 150, 8 if dim == 3 else 5,
                    lo=-13 if case == "negative" else 0)
        return c, c, hypercube_offsets(3, dim), len(c), len(c), 1
    if case in ("3d_lattice2", "6d_lattice2"):
        dim = 3 if case == "3d_lattice2" else 6
        c = downsample_coords(_coords(2, dim, 150, 10 if dim == 3 else 6),
                              2, 1)
        return c, c, hypercube_offsets(3, dim, 2), len(c), len(c), 2
    if case == "down_rect":   # fine level 0 -> coarse level 1, 6-D
        c = _coords(3, 6, 150, 5, lo=-2)
        coarse = downsample_coords(c, 2, 1)
        return c, coarse, hypercube_offsets(3, 6), len(c), len(coarse), 1
    assert case == "padded"  # 20 padded rows (zeros) on each side
    c = _coords(4, 3, 120, 7)
    pad = np.concatenate([c, np.zeros((20, 3), np.int32)])
    return pad, pad, hypercube_offsets(3, 3), len(c), len(c), 1


@pytest.mark.parametrize("case", ["3d", "6d", "3d_lattice2", "6d_lattice2",
                                  "padded", "down_rect", "negative"])
def test_device_kernel_map(case):
    """gmf_tpu's sorted probe and the port's host builder, bit for bit."""
    cin, cout, offs, n, m, lattice = _map_case(case)
    mask_in = (np.arange(len(cin)) < n).astype(np.float32)
    mask_out = (np.arange(len(cout)) < m).astype(np.float32)
    sentinel = len(cin)
    got = device_kernel_map(torch.tensor(cin), torch.tensor(cout), offs,
                            torch.tensor(mask_in), torch.tensor(mask_out),
                            sentinel, lattice=lattice)
    ref = jax_device_map(jnp.asarray(cin), jnp.asarray(cout),
                         jnp.asarray(offs), jnp.asarray(mask_in),
                         jnp.asarray(mask_out), sentinel=sentinel,
                         method="sort", lattice=lattice)
    _assert_same(got, ref)
    host, _ = build_kernel_map(cin[:n], cout[:m], offs)
    host = np.where(host == n, sentinel, host)
    np.testing.assert_array_equal(got[:, :m].numpy(), host)
    assert (got[:, m:] == sentinel).all()
    assert got.dtype == torch.int32 and (got != sentinel).any()


def test_device_kernel_map_frame_too_wide_raises():
    c = np.array([[0] * 6, [1 << 20] * 6], np.int32)
    with pytest.raises(ValueError, match=r"spans \[1048578, "):
        device_kernel_map(torch.tensor(c), torch.tensor(c),
                          hypercube_offsets(3, 6), torch.ones(2),
                          torch.ones(2), 2)


# dim, conv1 kernel, lowest coordinate, compact dense_frac (None: off)
PYRAMIDS = [(3, 3, 0, None), (3, 5, -6, None), (3, 7, 0, None),
            (6, 3, -2, None), (6, 3, -2, 0.25), (6, 3, 0, 0.5)]


@pytest.mark.parametrize("dim,conv1,lo,frac", PYRAMIDS)
def test_pyramid_against_gmf_tpu(dim, conv1, lo, frac):
    """Every key bit for bit: gmf_tpu's device pyramid (compacted where
    frac is set) and, uncompacted, gmf_tpu's and the port's host pyramids
    (FCGF's 5^3 conv1 among them). The stats equal the host pyramid's."""
    c = _coords(5, dim, 150, 10 if dim == 3 else 5, lo=lo)
    kw = dict(conv1_kernel_size=conv1, granule=64)
    stats = {}
    got = build_pyramid_arrays_device(
        c, 4, compact_conv=frac is not None, compact_dense_frac=frac or 0.5,
        device="cpu", stats=stats, **kw)
    assert got.pop("conv1_volume") == conv1 ** dim
    ref = jax_device_pyramid(c, 4, compact_conv=frac is not None,
                             compact_dense_frac=frac or 0.5, **kw)
    _assert_same(got, ref)
    host = build_pyramid(c, 4, **kw)
    want = kernel_map.pyramid_map_stats(host)
    assert stats["voxels"] == want["voxels"]
    for name, s in want["maps"].items():
        assert stats["maps"][name]["k"] == s["k"], name
        assert stats["maps"][name]["m"] == s["m"], name
        assert stats["maps"][name]["occupancy"] == pytest.approx(
            s["occupancy"], rel=1e-12), name
    if frac is not None:
        assert any(k.endswith("_cmp_0") for k in got)
        for name, s in stats["maps"].items():
            key = "conv1_cmp" if name == "conv1" else name.replace(
                "_", "_cmp_")
            assert (s["dense_rows"], s["compact_rows"]) == \
                compact.schedule_row_stats(got[key])
        return
    host_arrays = pyramid_to_arrays(host, "cpu")
    assert host_arrays.pop("conv1_volume") == conv1 ** dim
    _assert_same(got, jax_arrays(jax_build_pyramid(c, 4, **kw)))
    _assert_same(got, {k: v.numpy() for k, v in host_arrays.items()})


def _random_map(rng, K, M, cap_in, density):
    """[K, M] map, a unique input row per (offset, output) pair, skewed
    occupancy (tests/test_compact_conv.py's fixture)."""
    nbr = np.full((K, M), cap_in, np.int32)
    for k in range(K):
        hits = rng.rand(M) < density * rng.rand() ** 3
        nbr[k, hits] = rng.choice(cap_in, size=hits.sum(), replace=False)
    return nbr


@pytest.mark.parametrize("direction,frac", [("down", 0.25), ("down", 0.0),
                                            ("down", 9.9), ("up", 0.5)])
def test_sparse_conv_compact(direction, frac):
    """Schedules equal gmf_tpu's in every bit (and transpose_schedule the
    fused up schedule); the convolution within 1e-5 of gmf_tpu's and of
    the port's dense-map convolution, and so are its autograd
    gradients. frac 0.0 puts every offset in the dense tier, 9.9 none."""
    rng = np.random.RandomState(6)
    K, Mc, Mf, cin, cout = 27, 96, 120, 6, 5
    nbr = _random_map(rng, K, Mc, Mf, density=0.6)   # fine -> coarse
    counts = (nbr != Mf).sum(1)
    job = (nbr, counts, Mf, Mc, direction == "up", frac)
    got = compact.build_compact_schedules(
        [(torch.tensor(nbr),) + job[1:]])[0]
    ref = jcompact.build_compact_schedules([job])[0]
    _assert_same(got, ref)
    if direction == "up":
        _assert_same(compact.transpose_schedule(got[0], Mc, Mf), ref[1])
        sched, cap_in, rows = got[1], Mc, Mf
        dense = np.full((K, Mf), Mc, np.int32)    # the host's inversion
        for k, j in zip(*np.nonzero(nbr != Mf)):
            dense[k, nbr[k, j]] = j
        jsched = ref[1]
    else:
        sched, cap_in, rows, dense, jsched = got, Mf, Mc, nbr, ref
    x = rng.randn(cap_in, cin).astype(np.float32)
    w = rng.randn(K, cin, cout).astype(np.float32)
    # gradients with respect to the features before the sentinel row
    # (a constant that the two convolutions read different numbers of times)
    xs, xd = (torch.tensor(x).requires_grad_() for _ in range(2))
    wt, wd = (torch.tensor(w).requires_grad_() for _ in range(2))
    out = sparse_conv_compact(append_sentinel(xs), wt, sched, rows)
    want = jconv.sparse_conv_compact(jconv.append_sentinel(jnp.asarray(x)),
                                     jnp.asarray(w), jsched, rows)
    _close(out.detach().numpy(), want, 1e-5)
    plain = sparse_conv(append_sentinel(xd), wd, torch.tensor(dense))
    _close(out.detach().numpy(), plain.detach().numpy(), 1e-5)
    g = torch.tensor(rng.randn(rows, cout).astype(np.float32))
    gx, gw = torch.autograd.grad((out * g).sum(), (xs, wt))
    px, pw = torch.autograd.grad((plain * g).sum(), (xd, wd))
    _close(gx.numpy(), px.numpy(), 1e-5)
    _close(gw.numpy(), pw.numpy(), 1e-5)


@pytest.mark.parametrize("with_transpose", [False, True])
def test_build_compact_schedule_one_map(with_transpose):
    """The one-map form equals gmf_tpu's ``build_compact_schedule`` in
    every bit, and the list form's entry for the same job."""
    rng = np.random.RandomState(12)
    K, Mc, Mf = 27, 80, 100
    nbr = _random_map(rng, K, Mc, Mf, density=0.5)
    counts = (nbr != Mf).sum(1)
    got = compact.build_compact_schedule(torch.tensor(nbr), counts, Mf, Mc,
                                         with_transpose=with_transpose,
                                         dense_frac=0.25)
    _assert_same(got, jcompact.build_compact_schedule(
        nbr, counts, Mf, Mc, with_transpose=with_transpose,
        dense_frac=0.25))
    _assert_same(got, jcompact.build_compact_schedules(
        [(nbr, counts, Mf, Mc, with_transpose, 0.25)])[0])


def test_compact_scatter_modes_against_gmf_tpu():
    """Both scatter modes of both packages on one compacted schedule of a
    small 6-D cloud (the port's device pyramid, whose schedules equal
    gmf_tpu's): the port's "rowwise" within 1e-5 of gmf_tpu's "rowwise"
    relative to the largest entry, "flat" likewise, and the modes within
    1e-5 of each other. "rowwise" equals its plain version (an
    index_add_ a run of one offset's tiles, gmf_tpu's tile order) in
    every bit, at the default row budget and at one tile a step. An
    unknown mode raises."""
    c = _coords(7, 6, 150, 5)
    arrays = build_pyramid_arrays_device(c, 4, granule=64, compact_conv=True,
                                         compact_dense_frac=0.25,
                                         device="cpu")
    sched = arrays["self_cmp_0"]
    in_idx, out_idx, kept = sched["groups"][0]
    assert sched["dense"] is not None
    runs = torch.unique_consecutive(kept, return_counts=True)[1]
    assert len(runs) > 4 and int(runs.max()) > 1  # offsets of many tiles
    rows = arrays["mask_0"].shape[0]
    rng = np.random.RandomState(13)
    cin, cout = 5, 7
    x = rng.randn(rows, cin).astype(np.float32)
    w = rng.randn(3 ** 6, cin, cout).astype(np.float32)
    jsched = {"dense": tuple(jnp.asarray(a.numpy())
                             for a in sched["dense"]),
              "groups": tuple(tuple(jnp.asarray(a.numpy()) for a in g)
                              for g in sched["groups"])}
    xs = append_sentinel(torch.tensor(x))
    got, want = {}, {}
    for mode in ("flat", "rowwise"):
        got[mode] = sparse_conv_compact(xs, torch.tensor(w), sched, rows,
                                        scatter_mode=mode).numpy()
        want[mode] = np.asarray(jconv.sparse_conv_compact(
            jconv.append_sentinel(jnp.asarray(x)), jnp.asarray(w), jsched,
            rows, scatter_mode=mode))
        _close(got[mode], want[mode], 1e-5)
    _close(got["rowwise"], got["flat"], 1e-5)
    for budget in (1 << 16, in_idx.shape[1]):
        fast = sparse_conv_compact(xs, torch.tensor(w), sched, rows,
                                   row_budget=budget, scatter_mode="rowwise")
        plain = sparse_conv_compact_in_tile_order(
            xs, torch.tensor(w), sched, rows, row_budget=budget)
        np.testing.assert_array_equal(fast.numpy(), plain.numpy())
    # the module's mode, set across a net by set_scatter_mode
    mod = SparseConv(cin, cout, 3 ** 6)
    with torch.no_grad():
        mod.kernel.copy_(torch.tensor(w))
        assert set_scatter_mode(mod, "rowwise").scatter_mode == "rowwise"
        np.testing.assert_array_equal(mod(xs, sched, None, rows).numpy(),
                                      got["rowwise"])
    for bad in (lambda: sparse_conv_compact(xs, torch.tensor(w), sched, rows,
                                            scatter_mode="sorted"),
                lambda: set_scatter_mode(mod, "sorted")):
        with pytest.raises(ValueError, match="scatter_mode"):
            bad()


def _jax_net(kw, feats, arrays, images, seed=0):
    """gmf_tpu's net with non-trivial batch statistics
    (tests/test_torch_sparse.py)."""
    jm = JaxNet(**kw)
    v = jax.jit(jm.init)(jax.random.PRNGKey(seed), jnp.asarray(feats),
                         arrays, **images)
    r = np.random.RandomState(seed + 10)
    return jm, {"params": jax.tree.map(np.asarray, v["params"]),
                "batch_stats": jax.tree.map(
                    lambda a: (np.asarray(a) + 0.3 * r.rand(*np.shape(a))
                               ).astype(np.float32), v["batch_stats"])}


def test_inlier_net_compact_against_gmf_tpu():
    """The 6-D GMF inlier net on the port's compacted schedules against
    gmf_tpu's on its own, the same bridged weights: 1e-4 of the largest
    logit."""
    kw = dict(in_channels=1, out_channels=1, dim=6, conv1_kernel_size=3,
              with_gmf_fusion=True, image_dim=16, **NARROW)
    c = _coords(7, 6, 150, 5)
    r = np.random.RandomState(8)
    images = {k: r.rand(1, 16, 16, 3).astype(np.float32)
              for k in ("p_image", "q_image")}
    ref_arrays = jax_device_pyramid(c, 4, granule=64, compact_conv=True,
                                    compact_dense_frac=0.25)
    feats = r.rand(ref_arrays["mask_0"].shape[0], 1).astype(np.float32)
    feats *= np.asarray(ref_arrays["mask_0"])[:, None]
    jm, v = _jax_net(kw, feats, jax_arrays(jax_build_pyramid(c, 4,
                                                             granule=64)),
                     images)
    ref = np.asarray(jax.jit(jm.apply)(v, jnp.asarray(feats), ref_arrays,
                                       **images))
    tm = SparseResUNet2(**kw).eval()
    tm.load_state_dict(sparse_resunet_to_state_dict(v), strict=True)
    arrays = build_pyramid_arrays_device(c, 4, granule=64, compact_conv=True,
                                         compact_dense_frac=0.25,
                                         device="cpu")
    assert "self_cmp_0" in arrays and "self_map_0" not in arrays
    with torch.no_grad():
        got = tm(torch.tensor(feats), arrays,
                 **{k: torch.tensor(a) for k, a in images.items()})
    _close(got.numpy(), ref, 1e-4)


@pytest.fixture(scope="module")
def fcgf5():
    """gmf_tpu's FCGF with a 5^3 conv1 on its own pyramid, and its
    bridged weights."""
    c = _coords(9, 3, 150, 9, lo=-4)
    pyr = jax_arrays(jax_build_pyramid(c, 4, conv1_kernel_size=5,
                                       granule=256))
    feats = np.ones((pyr["mask_0"].shape[0], 1), np.float32)
    jm, v = _jax_net(dict(in_channels=1, out_channels=32, dim=3,
                          conv1_kernel_size=5, normalize_feature=True),
                     feats, pyr, {}, seed=2)
    ref = np.asarray(jax.jit(jm.apply)(v, jnp.asarray(feats), pyr))
    return c, feats, ref, sparse_resunet_to_state_dict(v)


@pytest.mark.parametrize("builder", ["host", "device"])
def test_fcgf_conv1_5_against_gmf_tpu(fcgf5, builder):
    """The port's FCGFNet(conv1_kernel_size=5) (the KITTI preset's) on
    either builder's pyramid against gmf_tpu's SparseResUNet2.apply:
    1e-5 of the largest entry."""
    c, feats, ref, state = fcgf5
    net = FCGFNet(conv1_kernel_size=5).eval()
    net.load_state_dict(state, strict=True)
    kw = dict(conv1_kernel_size=5, granule=256)
    arrays = (pyramid_to_arrays(build_pyramid(c, 4, **kw), "cpu")
              if builder == "host" else
              build_pyramid_arrays_device(c, 4, device="cpu", **kw))
    with torch.no_grad():
        got = net(torch.tensor(feats), arrays)
    _close(got.numpy(), ref, 1e-5)


@pytest.fixture(scope="module")
def engine_weights():
    fkw, ikw = _nets(7)
    return fkw, ikw, _jax_vars(fkw, ikw)


@pytest.fixture(scope="module")
def dgr_pair():
    from gmf_tpu_torch.data import dgr_loader

    p = dgr_loader.make_dgr_pair(np.random.RandomState(3), n_points=800,
                                 voxel_size=0.05, surface=True,
                                 image_hw=(16, 16))
    return p["pcd0"], p["pcd1"], p["p_image"][None], p["q_image"][None]


def test_register_device_maps_against_gmf_tpu(engine_weights, dgr_pair):
    """register() with device_kernel_maps=True (the compacted inlier
    convolution follows) in both packages, FCGF, the safeguard gate off:
    nn01 equal, weights within 1e-5, T within 1e-5. No map comes from a
    host builder."""
    je, te = _engines(engine_weights, device_kernel_maps=True,
                      safeguard_min_weight=0.0, safeguard_min_frac=0.0)
    assert te.config.use_compact_conv(te.device)
    ref = je.register(*dgr_pair)
    before = dict(kernel_map.BUILDS)
    te.stage_seconds = {}
    got = te.register(*dgr_pair)
    assert dict(kernel_map.BUILDS) == before
    assert "dense_rows" in te.last_inlier_maps["maps"]["self_0"]
    np.testing.assert_array_equal(got["corres"][1], ref["corres"][1])
    assert got["used_safeguard"] == ref["used_safeguard"] is False
    np.testing.assert_allclose(got["weights"], ref["weights"], atol=1e-5)
    np.testing.assert_allclose(got["trans"], ref["trans"], atol=1e-5)


def test_auto_rule_and_compact_without_device_maps(engine_weights,
                                                   dgr_pair):
    """None = on wherever the device is not the CPU, compact following
    the maps (gmf_tpu's rule by backend); compact without device maps is
    the host path with dense convolutions, bit for bit."""
    cfg = dgr.DGRConfig()
    for where, on in (("cpu", False), ("cuda", True),
                      (torch.device("cuda", 0), True)):
        assert cfg.use_device_maps(where) is on
        assert cfg.use_compact_conv(where) is on
    cfg = dgr.DGRConfig(device_kernel_maps=True, compact_inlier_conv=False)
    assert cfg.use_device_maps("cpu") and not cfg.use_compact_conv("cuda")
    assert not dgr.DGRConfig(device_kernel_maps=False).use_compact_conv(
        "cuda")
    _, plain = _engines(engine_weights)
    _, cmp_only = _engines(engine_weights, compact_inlier_conv=True)
    want = plain.register(*dgr_pair)
    before = kernel_map.BUILDS["native"]
    cmp_only.stage_seconds = {}
    got = cmp_only.register(*dgr_pair)
    assert kernel_map.BUILDS["native"] - before == 33  # 11 a pyramid
    assert "dense_rows" not in cmp_only.last_inlier_maps["maps"]["self_0"]
    for key in ("trans", "weights"):
        np.testing.assert_array_equal(got[key], want[key])
