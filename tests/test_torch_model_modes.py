"""The port's PointDSC in the reference's other modes vs gmf_tpu's.

The dense attention (``fused_attention=False``, the reference's default),
every ``knn_topk``, both ``hypo_scoring`` modes and both
``kabsch_method``s, in test mode and in the train branch, with the same
modes on both sides and the weights of one gmf_tpu init (bridged by
``utils/bridge.py``). gmf_tpu runs its dense path as is and its Pallas
kernels ("fused" kNN and counts) in interpret mode; the port runs its
kernels' plain versions on the CPU. Bounds are those of
tests/test_fused_model.py: final_trans atol 1e-3, labels agreement >=
0.99; the bf16 case those of tests/test_torch_model_bf16.py; the train
branch those of tests/torch_train_parity.py.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_train_parity as parity
from gmf_tpu.models import PointDSC as JaxPointDSC
from gmf_tpu_torch.eval.registration import PointDSCRegistrar
from gmf_tpu_torch.models import PointDSC
from gmf_tpu_torch.utils.bridge import flax_to_state_dict
from test_torch_model import KW, _problem

torch.set_num_threads(1)

DENSE = dict(fused_attention=False)
# the test-mode cases: the modes, the same on both sides
CASES = {
    "dense_exact_dense": dict(DENSE, knn_topk="exact", hypo_scoring="dense"),
    "dense_fused_fused": dict(DENSE, knn_topk="fused", hypo_scoring="fused"),
    "dense_values": dict(DENSE, knn_topk="values", hypo_scoring="dense"),
    "dense_approx": dict(DENSE, knn_topk="approx", hypo_scoring="fused"),
    "dense_svd": dict(DENSE, knn_topk="exact", hypo_scoring="dense",
                      kabsch_method="svd"),
    "fused_svd": dict(fused_attention=True, compat_cache="off",
                      knn_topk="fused", hypo_scoring="fused",
                      kabsch_method="svd"),
}
# the bf16 case: the card's dense serving modes ("auto" resolves to the
# kNN and counts kernels there; gmf_tpu names them)
BF16 = dict(DENSE, knn_topk="fused", hypo_scoring="fused")
THRESHOLD = 0.10  # PointDSC's inlier_threshold
NEAR = 1e-4       # bf16 labels may differ within this of it


@pytest.fixture(scope="module")
def init():
    """gmf_tpu's init of the tiny model (the parameters depend on the
    widths only, so one init serves every mode and N), as numpy: (the
    initial variables, the same with perturbed batch-norm statistics)."""
    corr, src, tgt, p_img, q_img, _ = _problem()
    v = jax.jit(JaxPointDSC(**KW).init)(jax.random.PRNGKey(0), *map(
        jnp.asarray, (corr, src, tgt, p_img, q_img)))
    v = jax.tree_util.tree_map(np.asarray, v)
    rng = np.random.RandomState(3)
    perturbed = dict(v, batch_stats=jax.tree_util.tree_map_with_path(
        lambda p, a: (0.5 + rng.rand(*a.shape) if p[-1].key == "var"
                      else 0.1 * rng.randn(*a.shape)).astype(np.float32),
        v["batch_stats"]))
    return v, perturbed


def _port(variables, dtype=torch.float32, **modes):
    m = PointDSC(device="cpu", dtype=dtype, **modes, **KW)
    m.load_state_dict(flax_to_state_dict(variables, KW["num_layers"]),
                      strict=True)
    return m


def _np32(x):
    return (np.asarray(jnp.asarray(x, jnp.float32))
            if isinstance(x, jax.Array) else x.float().numpy())


def _check_test_mode(init, modes):
    v = init[1]
    corr, src, tgt, p_img, q_img, mask = _problem()
    args = (corr, src, tgt, p_img, q_img)
    ref = JaxPointDSC(**modes, **KW).apply(
        v, *map(jnp.asarray, args), testing=True,
        corr_mask=jnp.asarray(mask))
    got = _port(v, **modes)(*map(torch.tensor, args), testing=True,
                            corr_mask=torch.tensor(mask))
    np.testing.assert_allclose(got["confidence"].numpy(),
                               _np32(ref["confidence"]), atol=1e-4)
    np.testing.assert_allclose(got["final_trans"].numpy(),
                               np.asarray(ref["final_trans"]), atol=1e-3)
    valid = mask > 0
    agree = (got["final_labels"].numpy()[valid]
             == _np32(ref["final_labels"])[valid]).mean()
    assert agree >= 0.99, agree
    assert (got["final_labels"].numpy()[~valid] == 0).all()
    assert got["seed_fitness"].dtype == torch.float32
    if modes["hypo_scoring"] == "dense":
        # both sides count the same direct residuals; the counts kernel
        # forms them as a bilinear form in the reference, where a point
        # within ~1e-5 of the threshold may count on one side only
        # (tests/test_torch_model_bf16.py)
        np.testing.assert_allclose(got["seed_fitness"].numpy(),
                                   _np32(ref["seed_fitness"]), atol=1e-6)


def _residuals(trans, src, tgt):
    """|R s + t - t'| per point in f64, [B, N]."""
    trans = np.asarray(trans, np.float64)
    pred = np.einsum("bij,bnj->bni", trans[:, :3, :3], src)
    return np.linalg.norm(pred + trans[:, None, :3, 3] - tgt, axis=-1)


def _check_bf16(init):
    """bf16 modules, dense: as tests/test_torch_model_bf16.py holds the
    fused path. End to end, the port's bf16 encoder no farther from the
    f32 encoder than 1.5x the reference's, the transforms within 1e-5 and
    the labels equal away from the threshold; then from the reference's
    own encoder output (a forward hook) the seed stage exactly: the
    confidence, the seed fitness (bf16) and the winning transforms."""
    v = init[1]
    corr, src, tgt, p_img, q_img, mask = _problem()
    args = (corr, src, tgt, p_img, q_img)
    ref, inter = JaxPointDSC(dtype=jnp.bfloat16, **BF16, **KW).apply(
        v, *map(jnp.asarray, args), testing=True,
        corr_mask=jnp.asarray(mask), capture_intermediates=True,
        mutable=["intermediates"])
    ref_enc = inter["intermediates"]["encoder"]["__call__"][0]
    assert ref_enc.dtype == jnp.bfloat16
    bf16 = _port(v, torch.bfloat16, **BF16)
    f32 = _port(v, **BF16)
    valid = mask > 0

    def run(model, features=None):
        seen = {}

        def hook(mod, inp, out):
            seen["enc"] = out.float().numpy()
            return features

        h = model.encoder.register_forward_hook(hook)
        try:
            out = model(*map(torch.tensor, args), testing=True,
                        corr_mask=torch.tensor(mask))
        finally:
            h.remove()
        return out, seen["enc"]

    got, port_enc = run(bf16)
    _, f32_enc = run(f32)
    ref_dev = np.abs(_np32(ref_enc) - f32_enc)[valid].max()
    port_dev = np.abs(port_enc - f32_enc)[valid].max()
    assert port_dev <= 1.5 * ref_dev, (port_dev, ref_dev)
    src64, tgt64 = src.astype(np.float64), tgt.astype(np.float64)
    near = np.abs(_residuals(ref["final_trans"], src64, tgt64)
                  - THRESHOLD) < NEAR
    labels_ref = _np32(ref["final_labels"])
    np.testing.assert_allclose(got["final_trans"].numpy(),
                               np.asarray(ref["final_trans"]), atol=1e-5)
    assert (got["final_labels"].numpy()[~near] == labels_ref[~near]).all()

    got, _ = run(bf16, torch.tensor(_np32(ref_enc)).to(torch.bfloat16))
    np.testing.assert_array_equal(got["confidence"].numpy(),
                                  _np32(ref["confidence"]))
    assert got["seed_fitness"].dtype == torch.bfloat16
    np.testing.assert_array_equal(_np32(got["seed_fitness"]),
                                  _np32(ref["seed_fitness"]))
    np.testing.assert_allclose(got["seed_trans"].numpy(),
                               np.asarray(ref["seed_trans"]), atol=1e-5)
    np.testing.assert_allclose(got["final_trans"].numpy(),
                               np.asarray(ref["final_trans"]), atol=1e-5)


def _check_train(init):
    """The dense train branch, the card's training modes (kNN and counts
    kernels): two steps and a skipped one against gmf_tpu's
    make_train_step, every check of tests/torch_train_parity.py."""
    steps = parity.run_steps("off", variables=init[0],
                             modes=dict(DENSE, knn_topk="fused",
                                        hypo_scoring="fused"))
    for check in (parity.check_metrics, parity.check_gradients,
                  parity.check_nan_batch_skipped,
                  parity.check_params_and_stats):
        check(steps)


@pytest.mark.parametrize("case", [*CASES, "bf16_dense", "train_dense"])
def test_mode_matches_jax(init, case):
    if case == "bf16_dense":
        _check_bf16(init)
    elif case == "train_dense":
        _check_train(init)
    else:
        _check_test_mode(init, CASES[case])


def test_dense_modes_resolve_as_the_reference(init):
    """"auto" is the kernels' mode (the reference's resolution on its
    accelerator) for kNN while k + 1 fits the kernel, and for scoring;
    past the kernel's width the kNN is exact. The dense model with
    "auto" equals the one with the kernels named."""
    v = init[1]
    corr, src, tgt, p_img, q_img, mask = _problem()
    args = [torch.tensor(a) for a in (corr, src, tgt, p_img, q_img)]
    auto = _port(v, **DENSE)
    assert auto._knn_mode(10) == "fused" and auto._knn_mode(128) == "exact"
    named = _port(v, **BF16)
    a = auto(*args, testing=True, corr_mask=torch.tensor(mask))
    b = named(*args, testing=True, corr_mask=torch.tensor(mask))
    for key in ("final_trans", "final_labels", "seed_fitness"):
        assert torch.equal(a[key], b[key]), key
    assert auto.config["fused_attention"] is False
    assert PointDSC(device="cpu", **KW).config["fused_attention"] is True


@pytest.mark.parametrize("name,kw,error", [
    ("knn_topk", dict(knn_topk="pallas"), ValueError),
    ("hypo_scoring", dict(hypo_scoring="sparse"), ValueError),
    ("kabsch_method", dict(kabsch_method="umeyama"), ValueError),
])
def test_unknown_modes_fail_by_name(name, kw, error):
    """Every mode the port does not know raises, naming it."""
    with pytest.raises(error, match=name):
        PointDSC(device="cpu", **kw, **KW)


@pytest.mark.parametrize("name", ["ring_mesh", "compat_cache_shards",
                                  "mesh"])
def test_mesh_settings(name):
    """The reference's mesh settings work on a mesh of one rank, and
    refuse what gmf_tpu refuses. ring_mesh: ring attention on a one-rank
    ring gives the model's result (tests/test_ring_model.py's limits),
    and N that does not divide the ring raises naming it.
    compat_cache_shards: the "auto" gate sizes ceil(B / shards) pairs;
    below 1 it raises. mesh: a registrar over a one-rank mesh gives the
    one without."""
    from gmf_tpu_torch.parallel.mesh import Mesh

    one = Mesh(1, 1, [0], 0, "cpu", None)
    corr, src, tgt, p_img, q_img, mask = map(torch.tensor, _problem())
    model = PointDSC(device="cpu", **DENSE, **KW)
    if name == "ring_mesh":
        ring = PointDSC(device="cpu", ring_mesh=one, **DENSE, **KW)
        ring.load_state_dict(model.state_dict())
        args = (corr, src, tgt, p_img, q_img)
        got = ring(*args, testing=True, corr_mask=mask)
        want = model(*args, testing=True, corr_mask=mask)
        np.testing.assert_allclose(got["final_trans"], want["final_trans"],
                                   atol=2e-4)
        np.testing.assert_allclose(got["confidence"], want["confidence"],
                                   atol=2e-3)
        ring.ring_mesh = Mesh(3, 1, [0, 1, 2], 0, "cpu", None)
        with pytest.raises(ValueError, match="ring"):
            ring(*args, testing=True, corr_mask=mask)
    elif name == "compat_cache_shards":
        from gmf_tpu_torch.models.pointdsc import _auto_compat_cache_dtype

        four = PointDSC(device="cpu", compat_cache_shards=4, **KW)
        assert four.auto_cache_dtype(256, 5000) is \
            _auto_compat_cache_dtype(64, 5000) is torch.int8
        assert model.auto_cache_dtype(256, 5000) is None
        for bad in (0, -2, 1.5):
            with pytest.raises(ValueError, match=name):
                PointDSC(device="cpu", compat_cache_shards=bad, **KW)
    else:
        samples = [dict(corr_pos=corr[i].numpy(), src_keypts=src[i].numpy(),
                        tgt_keypts=tgt[i].numpy(), p_image=p_img[i].numpy(),
                        q_image=q_img[i].numpy()) for i in range(2)]
        got = PointDSCRegistrar(model, mesh=one).register_batch(samples)
        want = PointDSCRegistrar(model).register_batch(samples)
        for (t, l), (wt, wl) in zip(got, want):
            np.testing.assert_array_equal(t, wt)
            np.testing.assert_array_equal(l, wl)


def test_nonlocal_block_heads_match_jax():
    """NonLocalBlock(num_heads=4) on the dense path against gmf_tpu's
    (bridged weights, eval mode, a masked pair): 1e-5 of the largest
    output; the fused and ring paths refuse more than one head."""
    from gmf_tpu.models.pointdsc import NonLocalBlock as JaxBlock
    from gmf_tpu_torch.models.pointdsc import NonLocalBlock
    from gmf_tpu_torch.utils.bridge import nonlocal_block_to_state_dict

    rng = np.random.RandomState(21)
    B, N, C, T = 2, 37, 16, 12
    feat = rng.randn(B, N, C).astype(np.float32)
    image = rng.randn(B, T, C).astype(np.float32)
    compat = rng.rand(B, N, N).astype(np.float32)
    mask = np.ones((B, N), np.float32)
    mask[1, 30:] = 0.0
    jm = JaxBlock(num_channels=C, num_heads=4)
    v = jax.jit(jm.init)(jax.random.PRNGKey(3), jnp.asarray(feat),
                         jnp.asarray(compat), jnp.asarray(image))
    stats = jax.tree.map(lambda a: np.asarray(a) + 0.5 * rng.rand(
        *np.shape(a)).astype(np.float32), v["batch_stats"])
    v = {"params": jax.tree.map(np.asarray, v["params"]),
         "batch_stats": stats}
    ref = np.asarray(jm.apply(v, jnp.asarray(feat), jnp.asarray(compat),
                              jnp.asarray(image),
                              corr_mask=jnp.asarray(mask)))
    block = NonLocalBlock(C, num_heads=4).eval()
    block.load_state_dict(nonlocal_block_to_state_dict(
        v["params"], v["batch_stats"]), strict=True)
    with torch.no_grad():
        got = block(torch.tensor(feat), torch.tensor(image),
                    torch.tensor(mask), None, None, fused=False,
                    attention=torch.tensor(compat)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())
    with pytest.raises(ValueError, match="one head"):
        block(torch.tensor(feat), torch.tensor(image), None, None, None,
              fused=True)
    with pytest.raises(ValueError, match="does not divide"):
        NonLocalBlock(C, num_heads=3)


@pytest.mark.parametrize("fused", [False, True])
def test_train_cli_records_attention_mode(tmp_path, fused):
    """train_pointdsc trains dense without --fused, as the reference's,
    and its snapshots record the modes it trained in."""
    cmd = [sys.executable, "-m", "gmf_tpu_torch.train.train_pointdsc",
           "--dataset", "synthetic", "--tiny", "--cpu", "--max-epoch", "1",
           "--steps-per-epoch", "1", "--batch-size", "2",
           "--save-dir", str(tmp_path)] + (["--fused"] if fused else [])
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                       cwd=root)
    assert r.returncode == 0, r.stderr[-3000:]
    with open(tmp_path / "model_best" / "config.json") as f:
        model = json.load(f)["model"]
    assert model["fused_attention"] is fused
    assert (model["knn_topk"], model["hypo_scoring"],
            model["kabsch_method"]) == ("auto", "auto", "quat")
