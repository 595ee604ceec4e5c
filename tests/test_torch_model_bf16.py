"""The port's bf16 model against gmf_tpu's bf16 model, with bridged weights.

Both packages run PointDSC with bf16 modules, the serving default on the
card, in test mode (compat_cache "off" and "int8"; JAX's Pallas kernels
in interpret mode, the port's plain versions on the CPU).

The two encoders do not round alike: XLA's CPU backend keeps f32 inside
its fusions where PyTorch rounds every bf16 operation. Their outputs lie
up to ~4 bf16 ulps apart, each ~1.2% of its scale from the f32 encoder,
so the end-to-end comparison holds the port's bf16 encoder no farther
from the f32 encoder than the reference's, and the transforms and
labels at stated bounds. The seed stage is then held exactly: the port's
encoder output is replaced by the reference's (a forward hook), and the
NMS seeds, the bf16 seed fitness, the winning seed of each pair and the
labels must equal the reference's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gmf_tpu.models import PointDSC as JaxPointDSC
from gmf_tpu.ops.fused_nms import pick_seeds_nms_fused as jax_nms
from gmf_tpu.ops.fused_scoring import seed_hypothesis_counts as jax_counts
from gmf_tpu_torch.models import PointDSC
from gmf_tpu_torch.ops.fused_nms import pick_seeds_nms_fused
from gmf_tpu_torch.ops.fused_scoring import seed_hypothesis_counts
from gmf_tpu_torch.utils.bridge import flax_to_state_dict
from test_torch_model import KW, _problem

torch.set_num_threads(1)

N = 400
THRESHOLD = 0.10       # PointDSC's inlier_threshold
NEAR = 1e-4            # labels and counts may differ within this of it
TRANS_ATOL = 1e-5      # end to end (measured <= 2.9e-6)
STAGE_TRANS_ATOL = 1e-5  # seed stage on equal features (measured 1e-6)


def _inputs():
    return _problem(seed=7, N=N, n_valid=(N, N - N // 5))


@pytest.fixture(scope="module")
def bf16_models():
    """(numpy flax variables with perturbed BN stats, port bf16 model,
    port f32 model), the weights of tests/test_torch_model.py's fixture
    drawn anew at N=400."""
    corr, src, tgt, p_img, q_img, _ = _inputs()
    jm = JaxPointDSC(fused_attention=True, compat_cache="off",
                     knn_topk="fused", hypo_scoring="fused",
                     dtype=jnp.bfloat16, **KW)
    v = jm.init(jax.random.PRNGKey(0), *map(jnp.asarray,
                                            (corr, src, tgt, p_img, q_img)))
    v = jax.tree_util.tree_map(np.asarray, v)
    rng = np.random.RandomState(3)
    v["batch_stats"] = jax.tree_util.tree_map_with_path(
        lambda p, a: (0.5 + rng.rand(*a.shape) if p[-1].key == "var"
                      else 0.1 * rng.randn(*a.shape)).astype(np.float32),
        v["batch_stats"])
    sd = flax_to_state_dict(v, KW["num_layers"])
    models = []
    for dtype in (torch.bfloat16, torch.float32):
        m = PointDSC(device="cpu", compat_cache="off", dtype=dtype, **KW)
        m.load_state_dict(sd, strict=True)
        models.append(m)
    return v, models[0], models[1]


def _np32(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if isinstance(
        x, jax.Array) else x.float().numpy()


def _residuals(trans, src, tgt):
    """|R s + t - t'| per point in f64: [B, N] or [B, S, N]."""
    trans = np.asarray(trans, np.float64)
    if trans.ndim == 3:
        return _residuals(trans[:, None], src, tgt)[:, 0]
    pred = np.einsum("bsij,bnj->bsni", trans[..., :3, :3], src)
    pred = pred + trans[:, :, None, :3, 3]
    return np.linalg.norm(pred - tgt[:, None], axis=-1)


def _run_port(model, args, mask, features=None):
    """The port's test-mode forward; ``features`` replaces the encoder's
    output; returns (outputs, the encoder's output as f32 numpy)."""
    seen = {}

    def hook(mod, inp, out):
        seen["enc"] = out.float().numpy()
        return None if features is None else features

    h = model.encoder.register_forward_hook(hook)
    try:
        out = model(*map(torch.tensor, args), testing=True,
                    corr_mask=torch.tensor(mask))
    finally:
        h.remove()
    return out, seen["enc"]


@pytest.mark.parametrize("compat_cache", ["off", "int8"])
def test_bf16_model_matches_gmf_tpu(bf16_models, compat_cache):
    v, bf16, f32 = bf16_models
    bf16.compat_cache = f32.compat_cache = compat_cache
    corr, src, tgt, p_img, q_img, mask = _inputs()
    args = (corr, src, tgt, p_img, q_img)
    jm = JaxPointDSC(fused_attention=True, compat_cache=compat_cache,
                     knn_topk="fused", hypo_scoring="fused",
                     dtype=jnp.bfloat16, **KW)
    ref, inter = jm.apply(v, *map(jnp.asarray, args), testing=True,
                          corr_mask=jnp.asarray(mask),
                          capture_intermediates=True,
                          mutable=["intermediates"])
    ref_enc = inter["intermediates"]["encoder"]["__call__"][0]
    assert ref_enc.dtype == jnp.bfloat16
    valid = mask > 0
    src64, tgt64 = src.astype(np.float64), tgt.astype(np.float64)

    # End to end: each bf16 encoder rounds its own way; the port's lies
    # no farther from the f32 encoder (held to gmf_tpu's f32 encoder in
    # test_torch_model.py) than gmf_tpu's does.
    got, port_enc = _run_port(bf16, args, mask)
    _, f32_enc = _run_port(f32, args, mask)
    ref_dev = np.abs(_np32(ref_enc) - f32_enc)[valid].max()
    port_dev = np.abs(port_enc - f32_enc)[valid].max()
    assert port_dev <= 1.5 * ref_dev, (port_dev, ref_dev)
    np.testing.assert_allclose(got["final_trans"].numpy(),
                               np.asarray(ref["final_trans"]),
                               atol=TRANS_ATOL)
    near = np.abs(_residuals(ref["final_trans"], src64, tgt64)
                  - THRESHOLD) < NEAR
    labels_ref = _np32(ref["final_labels"])
    assert (got["final_labels"].numpy()[~near]
            == labels_ref[~near]).all()

    # The seed stage on the reference's features.
    got, _ = _run_port(bf16, args, mask, features=torch.tensor(
        _np32(ref_enc)).to(torch.bfloat16))
    np.testing.assert_array_equal(got["confidence"].numpy(),
                                  _np32(ref["confidence"]))
    num_seeds = max(int(N * KW["ratio"]), 1)
    seeds_ref = np.asarray(jax_nms(
        jnp.asarray(src), ref["confidence"], 0.10, num_seeds,
        mask=jnp.asarray(mask), interpret=True))
    seeds = pick_seeds_nms_fused(torch.tensor(src), got["confidence"], 0.10,
                                 num_seeds, mask=torch.tensor(mask))
    np.testing.assert_array_equal(seeds.numpy(), seeds_ref)
    np.testing.assert_allclose(got["seed_trans"].numpy(),
                               np.asarray(ref["seed_trans"]),
                               atol=STAGE_TRANS_ATOL)

    # Fitness: the f32 ratio rounded to bf16, equal wherever the two
    # packages count the same inliers under their seed transforms. The
    # counters differ only through a point within NEAR of the threshold
    # (the reference's bilinear form against the port's direct residual):
    # at this input one count of 80, through a point 1.6e-5 from it.
    fit, fit_ref = got["seed_fitness"], ref["seed_fitness"]
    assert fit.dtype == torch.bfloat16 and fit_ref.dtype == jnp.bfloat16
    fit, fit_ref = _np32(fit), _np32(fit_ref)
    counts = seed_hypothesis_counts(
        got["seed_trans"], torch.tensor(src), torch.tensor(tgt), THRESHOLD,
        mask=torch.tensor(mask)).numpy()
    counts_ref = np.asarray(jax.vmap(
        lambda tr, s, t, m: jax_counts(tr, s, t, THRESHOLD, mask=m,
                                       interpret=True))(
        ref["seed_trans"], jnp.asarray(src), jnp.asarray(tgt),
        jnp.asarray(mask)))
    same = counts == counts_ref
    np.testing.assert_array_equal(fit[same], fit_ref[same])
    res_ref = _residuals(ref["seed_trans"], src64, tgt64)
    for b, s in zip(*np.nonzero(~same)):
        assert (np.abs(res_ref[b, s][valid[b]] - THRESHOLD) < NEAR).any()
    assert (~same).sum() <= 1, (~same).sum()

    # The winning seed: the first maximum of the bf16 fitness, among
    # ties that the f32 ratio would have broken.
    ties = [(fit_ref[b] == fit_ref[b].max()).sum() for b in range(2)]
    assert max(ties) >= 2, ties
    np.testing.assert_array_equal(fit.argmax(-1), fit_ref.argmax(-1))
    np.testing.assert_allclose(got["final_trans"].numpy(),
                               np.asarray(ref["final_trans"]),
                               atol=TRANS_ATOL)
    assert (got["final_labels"].numpy()[~near]
            == labels_ref[~near]).all()
    assert got["final_labels"].dtype == torch.float32  # numpy has no bf16


def _refinement_case(seed, B=2, n=1200):
    """Inliers of a z-rotation with 5 cm noise, 30% outliers, and a start
    0.02 rad off: counts above 512 move by less than one bf16 step."""
    rng = np.random.RandomState(seed)
    src = (rng.rand(B, n, 3) * 2.0).astype(np.float32)

    def rot(a):
        return np.array([[np.cos(a), -np.sin(a), 0],
                         [np.sin(a), np.cos(a), 0], [0, 0, 1]], np.float32)

    tgt = src @ rot(0.4).T + 0.05 * rng.randn(B, n, 3).astype(np.float32)
    out = rng.rand(B, n) < 0.3
    tgt[out] = rng.rand(out.sum(), 3) * 2.0
    trans = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    for b, a in enumerate(0.4 + 0.02 * rng.randn(B)):
        trans[b, :3, :3] = rot(a)
    return trans, src, tgt.astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_post_refinement_counts_in_bf16(seed):
    """Without a mask the reference counts inliers in bf16 (:802-805), so
    its refinement stops when a count moves within one bf16 step; with
    that rounding the port's bf16 refinement equals it, where an f32
    count lands 0.9-2.9e-3 away."""
    trans, src, tgt = _refinement_case(seed)
    out = {}
    for name, jdt, tdt in (("bf16", jnp.bfloat16, torch.bfloat16),
                           ("f32", jnp.float32, torch.float32)):
        ref = np.asarray(JaxPointDSC(dtype=jdt, **KW).apply(
            {}, *map(jnp.asarray, (trans, src, tgt)), None,
            method=JaxPointDSC._post_refinement))
        got = PointDSC(device="cpu", dtype=tdt, **KW)._post_refinement(
            *map(torch.tensor, (trans, src, tgt)), None).numpy()
        np.testing.assert_allclose(got, ref, atol=1e-5)
        out[name] = ref
    assert np.abs(out["bf16"] - out["f32"]).max() > 1e-4
