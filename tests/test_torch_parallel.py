"""gmf_tpu_torch.parallel (the mesh, ring attention, the collectives) and
every path that runs over a mesh, against gmf_tpu on the CPU.

Two worlds of gloo CPU ranks run once per module (``world2``,
``world4``), started on a thread as the module begins so that they run
while gmf_tpu compiles here: their ranks run
tests/torch_parallel_workers.py, which imports torch and the port only,
and the tests compare what they return with gmf_tpu, on its 8 virtual
CPU devices. PointDSC at gmf_tpu's
golden widths (1 layer, 16 channels, k=10), the dense modes that
gmf_tpu's "auto" takes on the CPU, weights from one gmf_tpu init.

Limits, each beside its assertion: the ring function 1e-5 (f32, the same
block order); the ring model gmf_tpu's own against its single-device
model (tests/test_ring_model.py: 2e-4 on the transform, 2e-3 on the
confidence, 1e-4 on the fitness); registrations tests/test_fused_model.py's
(1e-3 on the transform, 99% of labels); the sharded train step
gmf_tpu's (tests/test_parallel.py: loss 1e-4 relative, parameters 1e-5);
but where a parameter's gradient is rounding noise (a bias before a
batch norm), where Adam's first step may go either way, 2 lr as
tests/torch_train_parity.py allows); the DGR data-parallel step
gmf_tpu's (tests/test_dgr_dp.py: loss 1e-5
relative, updates 2e-3 of each leaf's update scale). gmf_tpu's ring
model and its DGR ``train_step_dp`` are not compiled here:
tests/test_ring_model.py and tests/test_dgr_dp.py hold those to the
single-device model and to the serial step, which these tests hold the
port to.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_workers as w
from gmf_tpu.data.correspondence import build_correspondences
from gmf_tpu.eval.registration import PointDSCRegistrar as JaxRegistrar
from gmf_tpu.models import PointDSC as JaxPointDSC
from gmf_tpu.models.pointdsc import _auto_compat_cache_dtype as jax_gate
from gmf_tpu.ops.fused_attention import padded_len
from gmf_tpu.parallel import mesh as jmesh
from gmf_tpu.parallel.ring_attention import \
    ring_compat_attention as jax_ring
from gmf_tpu.train.trainer import TrainConfig as JaxTrainConfig
from gmf_tpu.train.trainer import make_optimizer, make_train_step
from gmf_tpu_torch.data.synthetic import make_correspondence_problem
from gmf_tpu_torch.models import PointDSC
from gmf_tpu_torch.parallel.launch import launch
from gmf_tpu_torch.parallel.mesh import Mesh, sharded
from gmf_tpu_torch.utils.bridge import flax_to_state_dict

torch.set_num_threads(1)


def _batch():
    """The train step's global batch: 4 pairs of 100, pair 1's last 20
    rows masked."""
    b = make_correspondence_problem(np.random.RandomState(3), num_corr=100,
                                    inlier_ratio=0.5, image_hw=(16, 16),
                                    batch=4)
    mask = np.ones((4, 100), np.float32)
    mask[1, 80:] = 0.0
    for k in ("corr_pos", "src_keypts", "tgt_keypts", "labels"):
        b[k] = b[k] * (mask[..., None] if b[k].ndim == 3 else mask)
    b["corr_mask"] = mask
    return b


@pytest.fixture(scope="module")
def variables():
    """One gmf_tpu init of the tiny model, batch-norm statistics
    perturbed (so that eval mode reads something)."""
    args = map(jnp.asarray, w.model_problem()[:5])
    v = jax.jit(JaxPointDSC(**w.KW).init)(jax.random.PRNGKey(0), *args)
    v = jax.tree_util.tree_map(np.asarray, v)
    rng = np.random.RandomState(3)
    v["batch_stats"] = jax.tree_util.tree_map_with_path(
        lambda p, a: (0.5 + rng.rand(*a.shape) if p[-1].key == "var"
                      else 0.1 * rng.randn(*a.shape)).astype(np.float32),
        v["batch_stats"])
    return v


@pytest.fixture(scope="module", autouse=True)
def worlds(variables):
    """Both worlds, launched on threads at once: (world2, world4)
    futures."""
    state = {k: np.asarray(v) for k, v in
             flax_to_state_dict(variables, w.KW["num_layers"]).items()}
    with ThreadPoolExecutor(2) as pool:
        yield (pool.submit(launch, w.world2, 2,
                           dict(state=state, batch=_batch()), device="cpu",
                           threads=1, timeout=300),
               pool.submit(launch, w.world4, 4, None, device="cpu",
                           threads=1, timeout=300))


@pytest.fixture(scope="module")
def world2(worlds):
    return worlds[0].result()


@pytest.fixture(scope="module")
def world4(worlds):
    return worlds[1].result()


def _worlds(world2, world4):
    return {2: world2, 4: world4}


# -- the mesh ------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 4])
def test_make_mesh_and_shard_batch(world2, world4, n):
    """Every rank's mesh shape and position, and its shard of a batch,
    are gmf_tpu's mesh shape and the device's shard."""
    jm = jmesh.make_mesh(n_data=n)
    x = jmesh.shard_batch({"a": np.arange(16.0).reshape(8, 2)}, jm)["a"]
    shards = {s.device: np.asarray(s.data) for s in x.addressable_shards}
    for rank, res in enumerate(_worlds(world2, world4)[n]):
        facts = res["mesh"]
        assert facts["shape"] == dict(jm.shape)
        assert facts["index"] == {"data": rank, "model": 0}
        assert facts["backend"] == "gloo" and not facts["staging"]
        np.testing.assert_array_equal(facts["shard"],
                                      shards[jm.devices[rank, 0]])


def test_make_mesh_model_axis_and_refusal(world4):
    """A 2 x 2 mesh: gmf_tpu's shape, 'model' only replicating (ranks
    that differ only there hold the same shard); too large a mesh raises
    gmf_tpu's message."""
    jm = jmesh.make_mesh(n_data=2, n_model=2)
    for rank, res in enumerate(world4):
        m22 = res["mesh"]["mesh22"]
        assert m22["shape"] == dict(jm.shape)
        assert m22["index"] == {"data": rank // 2, "model": rank % 2}
        np.testing.assert_array_equal(
            m22["shard"], np.arange(8.0)[4 * (rank // 2):4 * (rank // 2) + 4])
    with pytest.raises(AssertionError) as e:
        jmesh.make_mesh(n_data=8, devices=jax.devices()[:4])
    assert world4[0]["mesh"]["too_big"] == str(e.value)


@pytest.mark.parametrize("n", [2, 4])
def test_process_shard(world2, world4, n):
    """Each rank's default shard is gmf_tpu's process_shard at its
    (index, count); without a world the whole list."""
    from gmf_tpu_torch.parallel.mesh import process_shard

    items = list(range(23))
    for rank, res in enumerate(_worlds(world2, world4)[n]):
        assert res["mesh"]["process_shard"] == jmesh.process_shard(
            items, rank, n)
    assert process_shard(items) == jmesh.process_shard(items) == items
    assert process_shard(items, 1, 4) == jmesh.process_shard(items, 1, 4)


def test_data_parallel_shardings():
    """gmf_tpu's (replicated, batch-sharded) pair, as the two placements:
    on a mesh of one rank, the tree itself and the whole batch."""
    from gmf_tpu_torch.parallel.mesh import data_parallel_shardings

    one = Mesh(1, 1, [0], 0, "cpu", None)
    rep, shard = data_parallel_shardings(one)
    tree = {"w": torch.ones(3)}
    assert rep(tree) is tree
    np.testing.assert_array_equal(shard(np.arange(6.0)).numpy(),
                                  np.arange(6.0))
    jrep, jshard = jmesh.data_parallel_shardings(jmesh.make_mesh(n_data=1))
    assert jrep.spec == () and tuple(jshard.spec) == ("data",)


# -- ring attention ----------------------------------------------------------

@pytest.fixture(scope="module")
def jax_ring_results():
    """gmf_tpu's ring over 4 devices, and the gradient of sum(out^2)."""
    mesh = jmesh.make_mesh(n_data=4)

    def loss(q, k, v, s, t, m):
        o = jax_ring(q, k, v, s, t, m, mesh, sigma_d=0.3)
        return jnp.sum(o ** 2), o

    step = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2),
                                      has_aux=True))
    out = {}
    for masked in (False, True):
        (_, o), g = step(*map(jnp.asarray, w.ring_inputs(masked)))
        out[masked] = dict(out=np.asarray(o), dq=np.asarray(g[0]),
                           dk=np.asarray(g[1]), dv=np.asarray(g[2]))
    return out


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("masked", [False, True])
def test_ring_function(world2, world4, jax_ring_results, n, masked):
    """Every rank's output equals gmf_tpu's 4-device ring (1e-5), and so
    does the gradient through the hops, relative to its largest entry;
    masked rows past the mask included."""
    ref = jax_ring_results[masked]
    for res in _worlds(world2, world4)[n]:
        got = res["ring"][masked]
        np.testing.assert_allclose(got["out"], ref["out"], atol=1e-5)
        for key in ("dq", "dk", "dv"):
            scale = np.abs(ref[key]).max()
            np.testing.assert_allclose(got[key] / scale, ref[key] / scale,
                                       atol=1e-5, err_msg=key)


@pytest.mark.parametrize("testing", [True, False])
def test_ring_model(world2, variables, testing):
    """The ring model over 2 ranks against gmf_tpu's single-device model
    with tests/test_ring_model.py's limits; the train branch's gradients
    through the ring equal the port's dense model's on one rank (1e-4 of
    each leaf's largest)."""
    args = [jnp.asarray(x) for x in w.model_problem()]
    mask = args.pop()
    ref = jax.jit(lambda v, *a: JaxPointDSC(**w.KW).apply(
        v, *a, testing=testing, corr_mask=mask))(variables, *args)
    for res in world2:
        rm = res["ring_model"]
        got = rm["ring"]["test" if testing else "train"]
        np.testing.assert_allclose(got["final_trans"],
                                   np.asarray(ref["final_trans"]), atol=2e-4)
        np.testing.assert_allclose(got["confidence"],
                                   np.asarray(ref["confidence"]), atol=2e-3)
        if testing:
            np.testing.assert_allclose(got["seed_fitness"],
                                       np.asarray(ref["seed_fitness"]),
                                       atol=1e-4)
        else:
            grads, dense = rm["ring"]["grads"], rm["dense"]["grads"]
            assert set(grads) == set(dense)
            for name in dense:
                scale = np.abs(dense[name]).max() + 1e-12
                np.testing.assert_allclose(grads[name] / scale,
                                           dense[name] / scale, atol=1e-4,
                                           err_msg=name)
    # every rank holds the same full gradient (nothing is summed after)
    for name, g in world2[0]["ring_model"]["ring"]["grads"].items():
        np.testing.assert_array_equal(
            g, world2[1]["ring_model"]["ring"]["grads"][name])


# -- the registrar and the service ---------------------------------------------

@pytest.fixture(scope="module")
def jax_registrar(variables):
    return JaxRegistrar(JaxPointDSC(**w.KW), variables,
                        mesh=jmesh.make_mesh(n_data=2), buckets=(w.BUCKET,))


def _assert_registrations(got, ref):
    assert len(got) == len(ref)
    agree, total = 0, 0
    for (t, l), (rt, rl) in zip(got, ref):
        np.testing.assert_allclose(t, np.asarray(rt), atol=1e-3)
        assert l.shape == np.asarray(rl).shape
        agree += int((l == np.asarray(rl)).sum())
        total += l.size
    assert agree >= 0.99 * total


def test_registrar_batched(world2, jax_registrar):
    """3 pairs over 2 ranks (padded with a copy of pair 0) against
    gmf_tpu's registrar on a 2-device mesh; both ranks return the whole
    batch; a single pair runs whole, as gmf_tpu's __call__; the model
    took compat_cache_shards = 2, as gmf_tpu's registrar clones it."""
    ref = jax_registrar.register_batch(w.corr_samples())
    for res in world2:
        reg = res["registrar"]
        _assert_registrations(reg["corr"], ref)
        _assert_registrations([reg["single"]],
                              [jax_registrar(w.corr_samples()[0])])
        assert reg["shards"] == jax_registrar.model.compat_cache_shards == 2


def test_registrar_raw_and_fragment_cache(world2, jax_registrar):
    """The raw-descriptor path (matching on the device in the model's
    call) over 2 ranks against gmf_tpu's on its mesh: the transforms and
    labels, and the matched rows each fetch writes back, equal to the
    host's build_correspondences; with a DeviceFragmentCache both
    requests return what the uncached one does."""
    raw = w.raw_samples(keys=False)
    ref = jax_registrar.register_batch(raw)
    for res in world2:
        reg = res["registrar"]
        _assert_registrations(reg["raw"], ref)
        for (src, tgt, labels), s in zip(reg["raw_rows"], raw):
            np.testing.assert_array_equal(src, s["src_keypts"])
            np.testing.assert_array_equal(tgt, s["tgt_keypts"])
            np.testing.assert_array_equal(labels, s["labels"])
        for (src, tgt, _), (i, j), s in zip(reg["raw_rows"], w.RAW_PAIRS,
                                            w.raw_samples(keys=False)):
            host = build_correspondences(
                s["src_keypts"], s["tgt_keypts"], s["src_desc"],
                s["tgt_desc"], s["gt_trans"], 0.10, use_mutual=True)
            np.testing.assert_array_equal(src, host["src_keypts"])
        for request in reg["cached"]:
            for (t, l), (rt, rl) in zip(request, reg["raw"]):
                np.testing.assert_allclose(t, rt, atol=1e-6)
                np.testing.assert_array_equal(l, rl)
        hits, misses = reg["cache_hits"]
        assert hits > 0 and misses > 0


def test_service_over_mesh(world2):
    """RegistrationService over the 2-rank registrar: rank 0 serves, rank
    1 follows its flushes; each result equals the direct register_batch
    on the same registrar (tests/test_serving.py's limits: 2e-5, labels
    equal)."""
    lead, follow = (r["service"] for r in world2)
    assert not lead["follower"] and follow["follower"]
    assert follow["served"] is None
    for (t, l), (dt, dl) in zip(lead["served"], lead["direct"]):
        np.testing.assert_allclose(t, dt, atol=2e-5)
        np.testing.assert_array_equal(l, dl)
    for (t, _), (dt, _) in zip(follow["direct"], lead["direct"]):
        np.testing.assert_array_equal(t, dt)


# -- training -----------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_step(variables):
    """gmf_tpu's jitted single-device train step on the global batch."""
    cfg = JaxTrainConfig()
    opt = make_optimizer(cfg, steps_per_epoch=1)
    step = jax.jit(make_train_step(JaxPointDSC(**w.KW), opt, cfg))
    params, stats, opt_state, metrics = step(
        variables["params"], variables["batch_stats"],
        opt.init(variables["params"]),
        {k: jnp.asarray(v) for k, v in _batch().items()}, jnp.asarray(1))
    # Adam's first moment after one step is 0.1 (g + wd p)
    grads = jax.tree_util.tree_map(
        lambda m, p: np.asarray(m) / 0.1 - cfg.weight_decay * np.asarray(p),
        opt_state[1][0].mu, variables["params"])

    def state(p):
        return flax_to_state_dict(jax.tree_util.tree_map(np.asarray, {
            "params": p, "batch_stats": stats}), w.KW["num_layers"])

    return ({k: float(v) for k, v in metrics.items()}, state(params),
            state(grads))


def test_sharded_trainer_step(world2, jax_step):
    """Trainer(mesh=2 ranks).train_step on the global batch equals
    gmf_tpu's single-device step: loss within 1e-4 relative, every new
    parameter within 1e-5 (2 lr where gmf_tpu's gradient is below 2e-3 of
    the largest: rounding noise, whose sign Adam's first step follows)
    and every running statistic within 1e-5, the same on both ranks;
    compat_cache_shards took the mesh's 2."""
    metrics, want, grads = jax_step
    lr = JaxTrainConfig().lr
    params = {k for k in world2[0]["trainer"]["state"] if k in grads
              and "running" not in k}
    gscale = max(np.abs(grads[k].numpy()).max() for k in params)
    for res in world2:
        tr = res["trainer"]
        np.testing.assert_allclose(tr["metrics"]["loss"], metrics["loss"],
                                   rtol=1e-4)
        assert tr["metrics"]["skipped_step"] == 0.0
        assert tr["shards"] == 2
        for key, value in want.items():
            got, ref = tr["state"][key], value.numpy()
            if key in params:
                noisy = np.abs(grads[key].numpy()) < 2e-3 * gscale
                assert (np.abs(got - ref)
                        <= np.where(noisy, 2 * lr, 1e-5)).all(), key
            else:
                np.testing.assert_allclose(got, ref, atol=1e-5, err_msg=key)
    for key, value in world2[0]["trainer"]["state"].items():
        np.testing.assert_array_equal(value, world2[1]["trainer"]["state"][key])


def _assert_updates_close(params0, expected, actual, atol=2e-3):
    """tests/test_dgr_dp.py's per-leaf comparison of applied updates."""
    for name, p0 in params0.items():
        ue, ud = expected[name] - p0, actual[name] - p0
        scale = np.abs(ue).max() + 1e-8
        np.testing.assert_allclose(ud / scale, ue / scale, atol=atol,
                                   err_msg=name)


def test_dgr_train_step_dp(world2):
    """train_step_dp over 2 ranks (3 pairs: padded with a weight-0 copy)
    against the same step on one rank and against the serial mean of the
    pairs' gradients on the step-initial statistics
    (tests/test_dgr_dp.py::_serial_expected): loss within 1e-5 relative,
    updates within 2e-3 of each leaf's update scale, statistics within
    1e-5 of the one-rank step's; the same on both ranks."""
    for res in world2:
        d = res["dgr"]
        assert d["dp"]["skipped"] == d["one"]["skipped"] == 0.0
        np.testing.assert_allclose(d["dp"]["loss"], d["one"]["loss"],
                                   rtol=1e-5)
        np.testing.assert_allclose(d["dp"]["loss"],
                                   np.mean(d["serial_losses"]), rtol=1e-5)
        _assert_updates_close(d["params0"], d["one_params"], d["dp_params"])
        _assert_updates_close(d["params0"], d["serial_params"],
                              d["dp_params"])
        for key, value in d["one_stats"].items():
            np.testing.assert_allclose(d["dp_stats"][key], value, atol=1e-5,
                                       err_msg=key)
    for key, value in world2[0]["dgr"]["dp_params"].items():
        np.testing.assert_array_equal(value,
                                      world2[1]["dgr"]["dp_params"][key])


def test_dgr_train_step_dp_nan_pair(world2):
    """A pair whose loss is not finite adds an exact zero: the step is
    applied, its loss is the mean over the finite pairs (1e-4 relative,
    tests/test_dgr_dp.py), every parameter stays finite."""
    d = world2[0]["dgr"]
    assert d["nan"]["skipped"] == 0.0
    np.testing.assert_allclose(d["nan"]["loss"],
                               np.mean(d["nan_finite_losses"]), rtol=1e-4)
    assert d["nan_params_finite"]


# -- the cache gate ------------------------------------------------------------

@pytest.mark.parametrize("b_global,n,ranks,shards", [
    (16, 5000, 2, 2),    # 8 a rank: the f32 cache on both
    (128, 5000, 2, 2),   # 64 a rank, the bench default: int8 on both
    (64, 5000, 2, 1),    # shards left at 1: the global estimate, 64: int8
    (256, 5000, 2, 2),   # 128 a rank: past both ceilings, streaming
    (128, 5000, 2, 1),   # 1: sized at the global 128, streaming
    (4, 12000, 2, 2),    # --kitti's N, 2 a rank: the f32 cache on both
])
def test_auto_cache_gate_sharded(b_global, n, ranks, shards):
    """The "auto" cache type each rank of a sharded batch takes is the
    one gmf_tpu takes for the global batch on the same mesh,
    ceil(B / compat_cache_shards) pairs (never divided twice)."""
    names = {torch.float32: "f32", torch.int8: "int8", None: None}
    jnames = {jnp.float32: "f32", jnp.int8: "int8", None: None}
    model = PointDSC(device="cpu", compat_cache_shards=shards, **w.KW)
    mesh = Mesh(ranks, 1, list(range(ranks)), 0, "cpu", None)
    with sharded(mesh):
        got = model.auto_cache_dtype(b_global // ranks, n)
    want = jax_gate(-(-b_global // shards), padded_len(n, interpret=False))
    assert names[got] == jnames[want]
    # unsharded, compat_cache_shards divides the batch the caller passes
    assert model.auto_cache_dtype(b_global, n) is got


def test_compat_cache_shards_refusal():
    """compat_cache_shards counts 'data' ranks: below 1 it is refused."""
    with pytest.raises(ValueError, match="compat_cache_shards"):
        PointDSC(device="cpu", compat_cache_shards=0, **w.KW)
