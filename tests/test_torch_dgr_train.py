"""gmf_tpu_torch's DGR training (train/dgr_trainer.py, the DGR losses,
data/transforms.py, train-mode MaskedBatchNorm and sparse_conv's
backward) against gmf_tpu on the same pairs and bridged weights (CPU,
f32).

Nets at gmf_tpu's trainer test widths (tests/test_dgr_trainer.py::
tiny_nets: channels 4/8/16/32, TR 8/8/8/16, image_dim 16, conv1 3^3 in
both nets), pairs of 300 points at voxel 0.08, granules 256. gmf_tpu's
side runs once, in a module fixture, and its jitted pair gradient is
compiled once: every pair's voxels fit one 256-row bucket, and every
kernel map is padded with all-sentinel rows to the full kernel volume
(27 in 3-D, 729 in 6-D), as gmf_tpu's own data-parallel step pads maps
to a common K' (``train_step_dp``); the padded rows add exactly zero.
The config's FCGF conv1 is 3 here, the tiny net's own: the port builds
each net's own conv1 map, gmf_tpu the config's.

Tolerances, each beside its assertion: per-pair gradients within 1e-4
of each leaf's largest entry (f32 through 17 sparse convolutions and
the image encoder, summed in other orders; measured: at most 3.4e-5, all
in the image encoder, whose train-mode batch norms normalise over the 4
positions a 16 x 16 frame leaves at stride 8; the other leaves below
1e-5), batch statistics and parameters within 1e-5, metrics within 1e-5
relative (rot_err, trans_err and the losses pass through arccos and
norms).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gmf_tpu.data import transforms as jtr
from gmf_tpu.sparse import conv as jconv
from gmf_tpu.sparse.kernel_map import build_pyramid as jax_build_pyramid
from gmf_tpu.sparse.resunet import SparseResUNet2 as JaxNet
from gmf_tpu.sparse.resunet import pyramid_to_arrays as jax_arrays
from gmf_tpu.train import losses as jlosses
from gmf_tpu_torch.data import transforms
from gmf_tpu_torch.sparse.conv import (MaskedBatchNorm, append_sentinel,
                                       sparse_conv)
from gmf_tpu_torch.sparse.kernel_map import build_pyramid
from gmf_tpu_torch.sparse.resunet import SparseResUNet2, pyramid_to_arrays
from gmf_tpu_torch.train import losses
from gmf_tpu_torch.utils.bridge import sparse_resunet_to_state_dict
from torch_dgr_parity import (G, GRAD_TOL, IKW, STATE_TOL, assert_metrics,
                              assert_state, jax_state, make_world,
                              port_trainer)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def world():
    return make_world()



# -- transforms, losses, the norm and the convolution -------------------------


def test_transforms_same_draws():
    pcd = np.random.RandomState(0).rand(50, 3)
    for seed in (1, 2):
        np.testing.assert_allclose(
            transforms.sample_random_trans(pcd, np.random.RandomState(seed),
                                           90.0),
            jtr.sample_random_trans(pcd, np.random.RandomState(seed), 90.0),
            rtol=0, atol=1e-12)
    np.testing.assert_allclose(
        transforms.rotation_about_axis([0.2, -1, 0.4], 0.7),
        jtr.rotation_about_axis([0.2, -1, 0.4], 0.7), rtol=0, atol=1e-12)
    coords, feats = pcd[:, :3], np.random.RandomState(3).rand(50, 4)
    outs = []
    for mod in (transforms, jtr):
        r = np.random.RandomState(5)
        comp = mod.Compose([mod.Jitter(rng=r), mod.ChromaticShift(rng=r)])
        outs.append([comp(coords, feats) for _ in range(6)])
    for (c0, f0), (c1, f1) in zip(*outs):
        np.testing.assert_array_equal(c0, c1)
        np.testing.assert_array_equal(f0, f1)
    it = [iter(mod.InfSampler(7, seed=3)) for mod in (transforms, jtr)]
    assert [next(it[0]) for _ in range(20)] == [next(it[1]) for _ in range(20)]


@pytest.mark.parametrize("masked", [False, True])
def test_bce_losses(masked):
    r = np.random.RandomState(1)
    logits = (3 * r.randn(64)).astype(np.float32)
    labels = (r.rand(64) > 0.7).astype(np.float32)
    mask = (np.arange(64) < 50).astype(np.float32) if masked else None
    for name in ("unbalanced_bce_loss", "balanced_bce_loss"):
        want = getattr(jlosses, name)(
            jnp.asarray(logits), jnp.asarray(labels),
            mask=None if mask is None else jnp.asarray(mask))
        got = getattr(losses, name)(
            torch.from_numpy(logits), torch.from_numpy(labels),
            mask=None if mask is None else torch.from_numpy(mask))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_masked_batch_norm_train_mode():
    """Output, gradients (x, scale, bias through the batch statistics)
    and the running statistics against flax's train mode, with padded
    rows."""
    r = np.random.RandomState(3)
    x = (2 * r.randn(40, 6) + 1).astype(np.float32)
    mask = (np.arange(40) < 29).astype(np.float32)
    dy = r.randn(40, 6).astype(np.float32)
    v = {"params": {"scale": r.rand(6).astype(np.float32) + 0.5,
                    "bias": r.randn(6).astype(np.float32)},
         "batch_stats": {"mean": r.randn(6).astype(np.float32),
                         "var": r.rand(6).astype(np.float32) + 0.5}}
    jbn = jconv.MaskedBatchNorm()

    def f(params, x):
        y, new = jbn.apply({"params": params,
                            "batch_stats": v["batch_stats"]}, x,
                           jnp.asarray(mask), train=True,
                           mutable=["batch_stats"])
        return jnp.sum(y * dy), (y, new["batch_stats"])

    (gp, gx), (y_ref, stats) = jax.grad(f, argnums=(0, 1), has_aux=True)(
        v["params"], jnp.asarray(x))
    bn = MaskedBatchNorm(6).train()
    with torch.no_grad():
        bn.bn.weight.copy_(torch.from_numpy(v["params"]["scale"]))
        bn.bn.bias.copy_(torch.from_numpy(v["params"]["bias"]))
        bn.bn.running_mean.copy_(torch.from_numpy(v["batch_stats"]["mean"]))
        bn.bn.running_var.copy_(torch.from_numpy(v["batch_stats"]["var"]))
    xt = torch.from_numpy(x).requires_grad_()
    y = bn(xt, torch.from_numpy(mask))
    (y * torch.from_numpy(dy)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), y_ref, rtol=0, atol=1e-5)
    assert not y[29:].any()  # padded rows multiplied to zero
    np.testing.assert_allclose(xt.grad.numpy(), gx, rtol=0, atol=1e-5)
    np.testing.assert_allclose(bn.bn.weight.grad.numpy(), gp["scale"],
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(bn.bn.bias.grad.numpy(), gp["bias"], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(bn.bn.running_mean.numpy(), stats["mean"],
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(bn.bn.running_var.numpy(), stats["var"],
                               rtol=0, atol=1e-6)


def _plain_sparse_conv(x, weights, nbr, chunk=32):
    """sparse_conv's forward as plain autograd sees it: the reference for
    its backward."""
    K, M = nbr.shape
    cin, cout = weights.shape[1], weights.shape[2]
    acc = torch.zeros(M, cout)
    for k0 in range(0, K, chunk):
        idx = nbr[k0:k0 + chunk]
        c = idx.shape[0]
        g = x.index_select(0, idx.t().reshape(-1)).view(M, c * cin)
        acc = acc + g @ weights[k0:k0 + c].reshape(c * cin, cout)
    return acc


@pytest.mark.parametrize("K", [27, 70])
def test_sparse_conv_backward(K):
    """The Function's output and gradients against plain autograd of the
    same sum (1e-6) and gmf_tpu's jax.vjp (1e-5), each of the largest
    entry, with input rows named by many offsets and many sentinel
    entries."""
    r = np.random.RandomState(K)
    cap_in, M, cin, cout = 50, 40, 5, 7
    x = r.randn(cap_in, cin).astype(np.float32)
    w = r.randn(K, cin, cout).astype(np.float32)
    nbr = r.randint(0, 12, (K, M)).astype(np.int32)    # repeated rows
    nbr[r.rand(K, M) < 0.4] = cap_in                    # sentinels
    dy = r.randn(M, cout).astype(np.float32)

    def run(fn):
        xt = torch.from_numpy(x).requires_grad_()
        wt = torch.from_numpy(w).requires_grad_()
        out = fn(append_sentinel(xt), wt, torch.from_numpy(nbr))
        (out * torch.from_numpy(dy)).sum().backward()
        return out.detach().numpy(), xt.grad.numpy(), wt.grad.numpy()

    def close(a, b, tol):  # relative to the largest entry
        b = np.asarray(b)
        assert np.abs(a - b).max() <= tol * np.abs(b).max()

    got, ref = run(sparse_conv), run(_plain_sparse_conv)
    for a, b in zip(got, ref):
        close(a, b, 1e-6)
    out, vjp = jax.vjp(
        lambda xx, ww: jconv.sparse_conv(jconv.append_sentinel(xx), ww,
                                         jnp.asarray(nbr)),
        jnp.asarray(x), jnp.asarray(w))
    for a, b in zip(got, (out, *vjp(jnp.asarray(dy)))):
        close(a, b, 1e-5)


# -- the nets in train mode and the trainer ----------------------------------


def test_tiny_nets_train_mode(world):
    """The inlier net in train mode: logits and the new batch statistics
    of every batch norm (masked and the image encoder's)."""
    pair = world["pairs"][0]
    coords = np.unique(np.concatenate(
        [pair["coords0"][:120], pair["coords1"][:120]], 1), axis=0)
    a = jax_arrays(jax_build_pyramid(coords, 4, granule=G))
    img = np.random.RandomState(2).rand(2, 1, 16, 16, 3).astype(np.float32)
    feats = np.ones((a["mask_0"].shape[0], 1), np.float32)
    ref, new = jax.jit(lambda *args, **kw: JaxNet(**IKW).apply(
        *args, **kw, train=True, mutable=["batch_stats"]))(
        world["iv"], jnp.asarray(feats), a, p_image=jnp.asarray(img[0]),
        q_image=jnp.asarray(img[1]))
    net = SparseResUNet2(**IKW)
    net.load_state_dict(sparse_resunet_to_state_dict(world["iv"]))
    arrays = pyramid_to_arrays(build_pyramid(coords, 4, granule=G), "cpu")
    got = net.train()(torch.from_numpy(feats), arrays,
                      p_image=torch.from_numpy(img[0]),
                      q_image=torch.from_numpy(img[1]))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=0, atol=1e-5)
    want = sparse_resunet_to_state_dict(jax.tree.map(
        np.asarray, {"params": world["iv"]["params"],
                     "batch_stats": new["batch_stats"]}))
    sd = net.state_dict()
    for k, v in want.items():
        if "running" in k:
            np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=0,
                                       atol=STATE_TOL, err_msg=k)


def test_pair_gradients(world):
    """Per-pair gradients leaf by leaf against gmf_tpu's ``_pair_grads``
    on two pairs, the batch statistics threaded from the first to the
    second, and each pair's metrics."""
    jt = world["jax"].trainer()
    pt = port_trainer(world["fv"], world["iv"], jt)
    names = [n for n, _ in pt.inlier.named_parameters()]
    for pair in world["pairs"]:
        jg, jm = jt.train_pair(pair)
        pg, pm = pt.train_pair(pair)
        want = sparse_resunet_to_state_dict(jax.tree.map(
            np.asarray, {"params": jg, "batch_stats": jt.inlier_bstats}))
        assert len(names) == len(pg)
        for name, g in zip(names, pg):
            w = want[name].numpy()
            scale = max(float(np.abs(w).max()), 1e-6)
            err = float(np.abs(g.numpy() - w).max())
            assert err <= GRAD_TOL * scale, (name, err, scale)
        assert_metrics(pm, jm)
        assert_state(pt, jax_state(jt), "batch statistics")


@pytest.mark.parametrize("optimizer,steps", [("SGD", 2), ("Adam", 1)])
def test_train_steps(world, optimizer, steps):
    """train_step of 2 pairs: the updated parameters, the statistics and
    the mean metrics (two SGD steps: the second at lr * gamma, the
    staircase at steps_per_epoch=1).

    Adam's first update is lr * g / (|g| + eps) of the decayed gradient
    g: about +-lr whatever |g|, so an entry whose g is within the
    gradients' own tolerance of 0 may take either sign. Such entries
    (|g| at most 1e-3 of the leaf's largest, 10x GRAD_TOL) are held to
    Adam's bound |step| <= lr; every other entry to STATE_TOL."""
    lr = 1e-2
    kw = dict(lr=lr, optimizer=optimizer)
    jt = world["jax"].trainer(**kw)
    pt = port_trainer(world["fv"], world["iv"], jt, **kw)
    decayed = {}
    step = pt.optimizer.step

    def record():
        decayed.update({n: (w.grad + pt.cfg.weight_decay * w).detach().clone()
                        for n, w in pt.inlier.named_parameters()})
        return step()

    pt.optimizer.step = record
    for _ in range(steps):
        before = {n: w.detach().clone()
                  for n, w in pt.inlier.named_parameters()}
        jm, pm = jt.train_step(world["pairs"]), pt.train_step(world["pairs"])
        assert pm["skipped"] == jm["skipped"] == 0.0
        assert_metrics(pm, jm)
        want = jax_state(jt)
        if optimizer == "Adam":
            for n, w in pt.inlier.named_parameters():
                g = decayed[n].abs()
                near0 = g <= 1e-3 * g.max()
                assert ((w - before[n]).abs()[near0] <= lr * 1.0001).all()
                want[n] = torch.where(near0, w.detach(), want[n])
        assert_state(pt, want, f"{optimizer} step")
    assert pt.applied_steps == steps
    assert math.isclose(pt.learning_rate(), lr * 0.99 ** steps)


@pytest.mark.parametrize("fault", ["loss", "gradient"])
def test_skips(world, fault, monkeypatch):
    """A pair whose loss is not finite adds nothing (its batch statistics
    stay); a non-finite mean gradient applies no update and does not
    advance the schedule: as gmf_tpu."""
    jt = world["jax"].trainer()
    pt = port_trainer(world["fv"], world["iv"], jt)
    pairs = [dict(p) for p in world["pairs"]]
    if fault == "loss":
        pairs[0]["T_gt"] = np.full((4, 4), np.nan, np.float32)
    else:
        j_pair, p_pair = jt.train_pair, pt.train_pair

        def j_nan(pair):
            g, m = j_pair(pair)
            return jax.tree.map(lambda a: a * jnp.nan, g), m

        def p_nan(pair):
            g, m = p_pair(pair)
            return [a * math.nan for a in g], m

        monkeypatch.setattr(jt, "train_pair", j_nan)
        monkeypatch.setattr(pt, "train_pair", p_nan)
    before = {k: v.clone() for k, v in pt.inlier.named_parameters()}
    jm, pm = jt.train_step(pairs), pt.train_step(pairs)
    assert pm["skipped"] == jm["skipped"] == (1.0 if fault == "gradient"
                                             else 0.0)
    assert_metrics(pm, jm)
    assert_state(pt, jax_state(jt), f"after a {fault} fault")
    if fault == "gradient":
        assert pt.applied_steps == 0
        for k, v in pt.inlier.named_parameters():
            assert torch.equal(v, before[k]), k
    # every pair's loss not finite: nothing but the statistics moves
    jm = jt.train_step([pairs[0]] if fault == "loss" else pairs)
    pm = pt.train_step([pairs[0]] if fault == "loss" else pairs)
    assert pm["skipped"] == jm["skipped"] == 1.0
    assert_state(pt, jax_state(jt), "after a skipped step")


def test_train_step_dp_one_rank(world):
    """train_step_dp of one pair on a one-rank mesh is gmf_tpu's
    train_step of that pair (the data-parallel step's step-initial
    statistics are the serial loop's for one pair): metrics, parameters
    and statistics within this file's bounds (two SGD steps). The
    multi-rank step: tests/test_torch_parallel.py."""
    from gmf_tpu_torch.parallel.mesh import Mesh

    one = Mesh(1, 1, [0], 0, "cpu", None)
    kw = dict(lr=1e-2, optimizer="SGD")
    jt = world["jax"].trainer(**kw)
    pt = port_trainer(world["fv"], world["iv"], jt, **kw)
    for _ in range(2):
        jm = jt.train_step(world["pairs"][:1])
        pm = pt.train_step_dp(world["pairs"][:1], one)
        assert pm["skipped"] == jm["skipped"] == 0.0
        assert_metrics(pm, jm)
        assert_state(pt, jax_state(jt), "train_step_dp")
    assert pt.applied_steps == 2
