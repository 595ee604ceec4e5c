"""The port's whole test-mode slice vs gmf_tpu's, with bridged weights.

JAX runs PointDSC(fused_attention=True, knn_topk="fused",
hypo_scoring="fused") in each compat_cache and seed_solver mode with its
Pallas kernels in interpret mode; the port runs the same slice in the same
mode on the CPU through its kernels' plain versions. Bounds are those of
tests/test_fused_model.py (final_trans atol 1e-3, labels agreement >=
0.99).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gmf_tpu.models import PointDSC as JaxPointDSC
from gmf_tpu.utils.convert_torch import convert_pointdsc
from gmf_tpu_torch.eval.registration import PointDSCRegistrar
from gmf_tpu_torch.models import PointDSC
from gmf_tpu_torch.models import pointdsc as port_pointdsc
from gmf_tpu_torch.utils.bridge import flax_to_state_dict

torch.set_num_threads(1)

KW = dict(num_layers=2, num_channels=32, ratio=0.1, k=10, sigma_d=0.10)


def _problem(seed=7, B=2, N=160, n_valid=(160, 130), hw=16):
    rng = np.random.RandomState(seed)
    src = (rng.rand(B, N, 3) * 2.5).astype(np.float32)
    tgt = np.empty_like(src)
    for b in range(B):
        ang = 0.3 + 0.2 * b
        R = np.array([[np.cos(ang), -np.sin(ang), 0],
                      [np.sin(ang), np.cos(ang), 0], [0, 0, 1]], np.float32)
        tgt[b] = src[b] @ R.T + np.array([0.2, 0.1, 0.05], np.float32)
        out = rng.choice(N, N // 3, replace=False)
        tgt[b, out] = rng.rand(N // 3, 3) * 2.5
    mask = np.zeros((B, N), np.float32)
    for b, n in enumerate(n_valid):
        mask[b, :n] = 1.0
    src *= mask[..., None]
    tgt *= mask[..., None]
    corr = np.concatenate([src - src.mean(1, keepdims=True),
                           tgt - tgt.mean(1, keepdims=True)], -1)
    corr *= mask[..., None]
    p_img = rng.rand(B, hw, hw, 3).astype(np.float32)
    q_img = rng.rand(B, hw, hw, 3).astype(np.float32)
    return corr, src, tgt, p_img, q_img, mask


@pytest.fixture(scope="module")
def models():
    """(jax model, numpy variables with perturbed BN stats, port model)."""
    corr, src, tgt, p_img, q_img, _ = _problem()
    jm = JaxPointDSC(fused_attention=True, compat_cache="off",
                     knn_topk="fused", hypo_scoring="fused", **KW)
    v = jm.init(jax.random.PRNGKey(0), *map(jnp.asarray,
                                            (corr, src, tgt, p_img, q_img)))
    v = jax.tree_util.tree_map(np.asarray, v)
    rng = np.random.RandomState(3)
    v["batch_stats"] = jax.tree_util.tree_map_with_path(
        lambda p, a: (0.5 + rng.rand(*a.shape) if p[-1].key == "var"
                      else 0.1 * rng.randn(*a.shape)).astype(np.float32),
        v["batch_stats"])
    tm = PointDSC(device="cpu", compat_cache="off", **KW)
    tm.load_state_dict(flax_to_state_dict(v, KW["num_layers"]), strict=True)
    return jm, v, tm


def _port_model(tm, **modes):
    """The fixture's port model (same weights) in other modes."""
    m = PointDSC(device="cpu", **modes, **KW)
    m.load_state_dict(tm.state_dict(), strict=True)
    return m


def _to_jax(x):
    return jnp.asarray(x)


def test_slice_matches_jax(models):
    jm, v, tm = models
    corr, src, tgt, p_img, q_img, mask = _problem()
    ref = jm.apply(v, *map(_to_jax, (corr, src, tgt, p_img, q_img)),
                   testing=True, corr_mask=jnp.asarray(mask))
    got = tm(*map(torch.tensor, (corr, src, tgt, p_img, q_img)),
             testing=True, corr_mask=torch.tensor(mask))
    np.testing.assert_allclose(got["confidence"].numpy(),
                               np.asarray(ref["confidence"]), atol=1e-4)
    np.testing.assert_allclose(got["final_trans"].numpy(),
                               np.asarray(ref["final_trans"]), atol=1e-3)
    valid = mask > 0
    agree = (got["final_labels"].numpy()[valid]
             == np.asarray(ref["final_labels"])[valid]).mean()
    assert agree >= 0.99, agree
    assert (got["final_labels"].numpy()[~valid] == 0).all()


@pytest.mark.parametrize("compat_cache,seed_solver", [
    ("int8", "auto"), ("f32", "auto"), ("bf16", "auto"),
    ("int8", "fused"), ("off", "fused")])
def test_slice_matches_jax_in_mode(models, compat_cache, seed_solver):
    """The slice as a whole in each cache mode and with the fused seed
    solver, the same mode on both sides, the bounds of
    test_slice_matches_jax. The cache and the solver add no parameters,
    so the fixture's variables serve every mode."""
    _, v, tm = models
    jm = JaxPointDSC(fused_attention=True, compat_cache=compat_cache,
                     seed_solver=seed_solver, knn_topk="fused",
                     hypo_scoring="fused", **KW)
    pm = _port_model(tm, compat_cache=compat_cache, seed_solver=seed_solver)
    corr, src, tgt, p_img, q_img, mask = _problem()
    ref = jm.apply(v, *map(_to_jax, (corr, src, tgt, p_img, q_img)),
                   testing=True, corr_mask=jnp.asarray(mask))
    got = pm(*map(torch.tensor, (corr, src, tgt, p_img, q_img)),
             testing=True, corr_mask=torch.tensor(mask))
    np.testing.assert_allclose(got["final_trans"].numpy(),
                               np.asarray(ref["final_trans"]), atol=1e-3)
    valid = mask > 0
    agree = (got["final_labels"].numpy()[valid]
             == np.asarray(ref["final_labels"])[valid]).mean()
    assert agree >= 0.99, agree
    assert (got["final_labels"].numpy()[~valid] == 0).all()
    assert np.isfinite(got["seed_trans"].numpy()).all()


@pytest.mark.parametrize("compat_cache,atol", [("f32", 1e-3), ("int8", 2e-3),
                                               ("bf16", 2e-3)])
def test_cache_modes_match_streaming(models, compat_cache, atol):
    """The port's cached models against its own streaming model, with the
    bounds tests/test_fused_model.py uses for the same comparison (f32
    1e-3; int8 2e-3, and bf16 with it: the same worst-case rounding of a
    compat near 1)."""
    _, _, tm = models
    pm = _port_model(tm, compat_cache=compat_cache)
    corr, src, tgt, p_img, q_img, mask = _problem()
    args = list(map(torch.tensor, (corr, src, tgt, p_img, q_img)))
    ref = tm(*args, testing=True, corr_mask=torch.tensor(mask))
    got = pm(*args, testing=True, corr_mask=torch.tensor(mask))
    np.testing.assert_allclose(got["final_trans"].numpy(),
                               ref["final_trans"].numpy(), atol=atol)
    valid = mask > 0
    assert (got["final_labels"].numpy()[valid]
            == ref["final_labels"].numpy()[valid]).mean() > 0.99


def test_fused_seed_solver_matches_plain_chain(models):
    """seed_solver="fused" (fixed count) against the early-exit chain on
    the port: equal at convergence (the bounds of
    tests/test_fused_seed_solver.py's model test)."""
    _, _, tm = models
    pm = _port_model(tm, compat_cache="off", seed_solver="fused")
    corr, src, tgt, p_img, q_img, mask = _problem()
    args = list(map(torch.tensor, (corr, src, tgt, p_img, q_img)))
    ref = tm(*args, testing=True, corr_mask=torch.tensor(mask))
    got = pm(*args, testing=True, corr_mask=torch.tensor(mask))
    np.testing.assert_allclose(got["final_trans"].numpy(),
                               ref["final_trans"].numpy(), atol=1e-4)
    np.testing.assert_allclose(got["seed_fitness"].numpy(),
                               ref["seed_fitness"].numpy(), atol=1e-6)


@pytest.mark.parametrize("B,N,want", [
    (8, 5000, torch.float32),   # 0.8e9 bytes of f32: the exact cache
    (64, 5000, torch.int8),     # bench default, 1.6e9 bytes of int8
    (8, 12000, torch.int8),     # --kitti
    (2, 30000, torch.int8),     # --lomatch, 1.8e9 bytes
    (128, 5000, None),          # past the int8 ceiling: stream
])
def test_auto_compat_cache_gate(B, N, want):
    """A pure function of (B, N) with named ceilings; all three bench
    presets take the int8 cache."""
    assert port_pointdsc._auto_compat_cache_dtype(B, N) is want
    assert port_pointdsc.AUTO_F32_CACHE_MAX_BYTES == 1.5e9
    assert port_pointdsc.AUTO_INT8_CACHE_MAX_BYTES >= 2.0e9


def test_auto_is_streaming_on_cpu_and_modes_are_checked(models):
    """"auto" resolves to "off" for CPU tensors whatever the size, so the
    default model equals the streaming one bit for bit; a named type is
    taken on the CPU too; unknown modes raise ValueError."""
    _, _, tm = models
    corr, src, tgt, p_img, q_img, mask = _problem()
    auto = _port_model(tm)
    assert auto.compat_cache == "auto" and auto.seed_solver == "auto"
    s, t = torch.tensor(src), torch.tensor(tgt)
    assert auto._build_compat_cache(s, t) == (None, False)
    assert _port_model(tm, compat_cache="int8")._build_compat_cache(
        s, t) == (None, True)
    cache, build = _port_model(tm, compat_cache="bf16")._build_compat_cache(
        s, t)
    assert cache.dtype == torch.bfloat16 and not build
    args = list(map(torch.tensor, (corr, src, tgt, p_img, q_img)))
    ref = tm(*args, testing=True, corr_mask=torch.tensor(mask))
    got = auto(*args, testing=True, corr_mask=torch.tensor(mask))
    np.testing.assert_array_equal(got["final_trans"].numpy(),
                                  ref["final_trans"].numpy())
    with pytest.raises(ValueError, match="compat_cache"):
        PointDSC(device="cpu", compat_cache="fp8", **KW)
    with pytest.raises(ValueError, match="seed_solver"):
        PointDSC(device="cpu", seed_solver="pallas", **KW)


def test_registrar_requests_match_direct_calls(models):
    """Two requests of different N: each result equals a direct model call
    on the same bucket-padded batch."""
    _, _, tm = models
    reg = PointDSCRegistrar(tm, buckets=(128, 256))
    for seed, n in ((11, 100), (12, 230)):
        corr, src, tgt, p_img, q_img, _ = _problem(seed=seed, N=n,
                                                   n_valid=(n, n))
        samples = [dict(corr_pos=corr[b], src_keypts=src[b],
                        tgt_keypts=tgt[b], p_image=p_img[b],
                        q_image=q_img[b]) for b in range(2)]
        samples[1] = {k: (a[: n - 20] if a.shape[0] == n else a)
                      for k, a in samples[1].items()}
        served = reg.register_batch(samples)
        bucket = 128 if n <= 128 else 256

        def pad(a):
            out = np.zeros((bucket,) + a.shape[1:], np.float32)
            out[: len(a)] = a
            return out

        batch = {k: torch.tensor(np.stack([pad(s[k]) for s in samples]))
                 for k in ("corr_pos", "src_keypts", "tgt_keypts")}
        mask = torch.tensor(np.stack(
            [(np.arange(bucket) < len(s["corr_pos"])).astype(np.float32)
             for s in samples]))
        direct = tm(batch["corr_pos"], batch["src_keypts"],
                    batch["tgt_keypts"],
                    torch.tensor(np.stack([s["p_image"] for s in samples])),
                    torch.tensor(np.stack([s["q_image"] for s in samples])),
                    testing=True, corr_mask=mask)
        for i, (trans, labels) in enumerate(served):
            n_i = len(samples[i]["corr_pos"])
            assert labels.shape == (n_i,)
            np.testing.assert_array_equal(
                trans, direct["final_trans"][i].numpy())
            np.testing.assert_array_equal(
                labels, direct["final_labels"][i, :n_i].numpy())
        assert reg(samples[0])[0].shape == (4, 4)


def test_bridge_round_trip(models):
    """flax -> state_dict -> convert_pointdsc -> flax is bit-equal."""
    _, v, tm = models
    sd = flax_to_state_dict(v, KW["num_layers"])
    assert set(sd) == set(tm.state_dict())
    back = convert_pointdsc({k: t.numpy() for k, t in sd.items()},
                            num_layers=KW["num_layers"])
    flat_v = jax.tree_util.tree_flatten_with_path(v)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_v) == len(flat_b)
    for path, leaf in flat_v:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), leaf)
