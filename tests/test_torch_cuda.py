"""The port's CUDA kernels vs their plain versions, on the card.

Every test here needs a CUDA device (the kernels have no CPU mode) and
skips without one. The file imports neither JAX nor gmf_tpu, so on a
machine with a card and no JAX it runs on its own:

    python -m pytest --noconftest -o addopts="" tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from gmf_tpu_torch.data.synthetic import make_correspondence_problem
from gmf_tpu_torch.eval.registration import PointDSCRegistrar
from gmf_tpu_torch.models import PointDSC
from gmf_tpu_torch.ops import _build
from gmf_tpu_torch.ops.flash_variants import (IN_KERNEL,
                                              KERNELS as VARIANT_KERNELS,
                                              flash_variant,
                                              flash_variant_plain)
from gmf_tpu_torch.ops.fused_attention import (
    _cached_forward, _load_compat, _logits_plain, _stream_compat_plain,
    _streaming_forward, build_compat_cache,
    build_compat_cache_plain, compat_attention_bwd_plain,
    compat_attention_cached_plain, compat_attention_plain,
    compat_flash_attention, compat_flash_attention_build,
    compat_flash_attention_build_plain, compat_flash_attention_bwd)
from gmf_tpu_torch.ops.fused_nms import nms_local_max, nms_local_max_plain
from gmf_tpu_torch.ops.fused_scoring import (seed_hypothesis_counts,
                                             seed_hypothesis_counts_plain)
from gmf_tpu_torch.ops.fused_seed_solver import (fused_seed_transforms,
                                                 fused_seed_weights,
                                                 fused_seed_weights_plain)
from gmf_tpu_torch.ops.fused_topk import seed_knn_topk, seed_knn_topk_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture
def gen():
    return np.random.RandomState(5)


def _t(x, dev):
    return torch.tensor(np.asarray(x)).to(dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [32, 128])
def test_attention_kernel(gen, cuda, dtype, D):
    """N=333 is no multiple of the 64-row blocks. f32: summation order
    only. bf16: both round q*scale and p to bf16 as the TPU kernel does,
    and round the output to bf16, which may land on the neighbouring bf16
    value: 2 ulps at the largest output."""
    B, N = 2, 333
    q, k, v = (_t(gen.randn(B, N, D).astype(np.float32), cuda).to(dtype)
               for _ in range(3))
    src = gen.rand(B, N, 3).astype(np.float32) * 2.5
    tgt = src + 0.02 * gen.randn(B, N, 3).astype(np.float32)
    mask = np.ones((B, N), np.float32)
    mask[0, 250:] = 0.0
    src, tgt, m = _t(src, cuda), _t(tgt, cuda), _t(mask, cuda)
    before = _build.launches["compat_flash_attention"]
    got = compat_flash_attention(q, k, v, src, tgt, mask=m)
    assert _build.launches["compat_flash_attention"] == before + 1
    ref = compat_attention_plain(q, k, v, src, tgt, mask=m)
    atol = 1e-5
    if dtype == torch.bfloat16:
        ref_max = ref.float().abs().max().item()
        atol = 2 * 2.0 ** (np.floor(np.log2(ref_max)) - 7)
    torch.testing.assert_close(got.float(), ref.float(), atol=atol, rtol=0)


def _attention_inputs(gen, cuda, dtype, D, B=2, N=333, extent=2.5):
    q, k, v = (_t(gen.randn(B, N, D).astype(np.float32), cuda).to(dtype)
               for _ in range(3))
    src = gen.rand(B, N, 3).astype(np.float32) * extent
    tgt = src + 0.02 * gen.randn(B, N, 3).astype(np.float32)
    tgt[:, ::3] = gen.rand(B, (N + 2) // 3, 3).astype(np.float32) * extent
    mask = np.ones((B, N), np.float32)
    mask[0, 250:] = 0.0
    return q, k, v, _t(src, cuda), _t(tgt, cuda), _t(mask, cuda)


def _out_atol(ref, dtype):
    """f32: summation order. bf16: 2 ulps at the largest output."""
    if dtype == torch.float32:
        return 1e-5
    return 2 * 2.0 ** (np.floor(np.log2(ref.float().abs().max().item())) - 7)


@pytest.mark.parametrize("extent", [2.5, 120.0])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_build_compat_cache_kernel(gen, cuda, dtype, extent):
    """The kernel rounds every operation as the plain version does (no
    FMA contraction, IEEE sqrt and division): equal in every byte, pad
    columns included, at metre and at 120 m extents (sigma_d 0.1 / 1.2)."""
    _, _, _, src, tgt, _ = _attention_inputs(gen, cuda, torch.float32, 32,
                                             extent=extent)
    sigma_d = 0.10 if extent < 10 else 1.2
    before = _build.launches["build_compat_cache"]
    got = build_compat_cache(src, tgt, sigma_d, dtype)
    assert _build.launches["build_compat_cache"] == before + 1
    ref = build_compat_cache_plain(src, tgt, sigma_d, dtype)
    assert got.shape == ref.shape and got.dtype == dtype
    assert torch.equal(got, ref)
    assert 0.02 < (ref[:, :, :333].float() != ref.float().min()).float(
        ).mean() < 1.0  # the problem is not all-zero compat


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [32, 128])
def test_build_attend_kernel(gen, cuda, dtype, D):
    """The emitted cache equals the standalone int8 cache and the plain
    version's in every byte; the output equals the cached kernel's on
    that cache exactly (same core, same dequantized codes) and the plain
    version's within the attention limits."""
    q, k, v, src, tgt, m = _attention_inputs(gen, cuda, dtype, D)
    before = _build.launches["compat_flash_attention_build"]
    out, cache = compat_flash_attention_build(q, k, v, src, tgt, mask=m)
    assert _build.launches["compat_flash_attention_build"] == before + 1
    alone = build_compat_cache(src, tgt, 0.10, torch.int8)
    assert torch.equal(cache, alone)
    ref_out, ref_cache = compat_flash_attention_build_plain(
        q, k, v, src, tgt, mask=m)
    assert torch.equal(cache, ref_cache)
    cached = compat_flash_attention(q, k, v, None, None, mask=m,
                                    compat=cache)
    assert torch.equal(out, cached)
    torch.testing.assert_close(out.float(), ref_out.float(),
                               atol=_out_atol(ref_out, dtype), rtol=0)


@pytest.mark.parametrize("cache_dtype",
                         [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [32, 128])
def test_cached_attention_kernel(gen, cuda, dtype, D, cache_dtype):
    """The int8 dequantization is one FMA in the kernel and a product then
    a sum in the plain version: at most one f32 ulp of a compat in [0, 1]
    (6e-8), far beneath the output limits (f32 1e-5, bf16 2 ulps)."""
    q, k, v, src, tgt, m = _attention_inputs(gen, cuda, dtype, D)
    cache = build_compat_cache(src, tgt, 0.10, cache_dtype)
    before = _build.launches["compat_flash_attention_cached"]
    got = compat_flash_attention(q, k, v, None, None, mask=m, compat=cache)
    assert _build.launches["compat_flash_attention_cached"] == before + 1
    ref = compat_attention_cached_plain(q, k, v, cache, mask=m)
    torch.testing.assert_close(got.float(), ref.float(),
                               atol=_out_atol(ref, dtype), rtol=0)
    with pytest.raises(ValueError, match="layout"):
        compat_flash_attention(q, k, v, None, None, mask=m,
                               compat=cache[:, :, :-1])


# launches of one flash_variant call, by variant
_VARIANT_LAUNCHES = {
    **{v: {name: 1} for v, name in VARIANT_KERNELS.items()},
    "v2": {"compat_flash_attention": 1},
}


@pytest.mark.parametrize("variant", IN_KERNEL)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [32, 128])
def test_flash_variant_kernel(gen, cuda, dtype, D, variant):
    """Each variant of the microbenchmark at N=333 (no multiple of the
    64-row blocks or the 32-key tiles), pair 0 partly masked, against
    flash_variant_plain, with the launches it makes. v0, v1, v3 and v6 are
    the four instances of compat_flash_variants.cu: kernel and plain
    version round every compat operation alike, so they differ by the
    softmax's summation order and running max only: f32 1e-5, bf16 2 ulps
    at the largest output. v2 launches the streaming kernel, held to the
    same limits (v4 and v5 are the cached kernel on a standalone cache:
    test_cached_attention_kernel)."""
    q, k, v, src, tgt, m = _attention_inputs(gen, cuda, dtype, D)
    before = _build.launches.copy()
    got = flash_variant(q, k, v, src, tgt, mask=m, variant=variant)
    torch.cuda.synchronize()
    made = {n: c - before[n] for n, c in _build.launches.items()
            if c != before[n]}
    assert made == _VARIANT_LAUNCHES[variant]
    ref = flash_variant_plain(q, k, v, src, tgt, mask=m, variant=variant)
    assert got.dtype == dtype and got.shape == ref.shape
    torch.testing.assert_close(got.float(), ref.float(),
                               atol=_out_atol(ref, dtype), rtol=0)


def _bf16_ulp(x):
    return 2.0 ** (np.floor(np.log2(x)) - 7)


@pytest.mark.parametrize("cache_dtype",
                         [None, torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [32, 128])
def test_attention_backward_kernels(gen, cuda, dtype, D, cache_dtype):
    """Through autograd: the forward kernel (streaming, or cached on each
    cache type) writes the lse, then the dK/dV and the dQ kernels run.
    lse: 1e-5 against the plain forward's (f32 summation order), and each
    valid row's p = exp2(s - lse) sums to 1 within 1e-5. Gradients against
    the plain backward on the same out and lse: f32 within 1e-5 of the
    largest entry (summation order); bf16 within 4 bf16 ulps of it (both
    round p and dlogits to bf16 before their products, so an operand near
    a rounding edge may take the neighbouring value, and both round the
    result to bf16). Masked query rows get a dq of exactly 0."""
    q, k, v, src, tgt, m = _attention_inputs(gen, cuda, dtype, D)
    do = _t(gen.randn(*q.shape).astype(np.float32), cuda).to(dtype)
    cache = (None if cache_dtype is None
             else build_compat_cache(src, tgt, 0.10, cache_dtype))
    fwd, dkv, dq_name = (
        ("compat_flash_attention", "compat_flash_attention_bwd_dkv",
         "compat_flash_attention_bwd_dq") if cache is None else
        ("compat_flash_attention_cached",
         "compat_flash_attention_cached_bwd_dkv",
         "compat_flash_attention_cached_bwd_dq"))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    _build.reset_launches()
    out = compat_flash_attention(*leaves, src, tgt, mask=m, compat=cache)
    out.backward(do)
    assert [_build.launches[n] for n in (fwd, dkv, dq_name)] == [1, 1, 1]
    got = [x.grad for x in leaves]

    if cache is None:
        ref_out, ref_lse = compat_attention_plain(q, k, v, src, tgt, m,
                                                  return_lse=True)
        compat = _stream_compat_plain(src, tgt, 0.10)
    else:
        ref_out, ref_lse = compat_attention_cached_plain(
            q, k, v, cache, m, return_lse=True)
        compat = _load_compat(cache, q.shape[1])
    # the kernel's lse, read back through a forward that returns it
    lse = (_streaming_forward(q, k, v, src, tgt, m, 0.10, True)[1]
           if cache is None else _cached_forward(q, k, v, cache, m, True)[1])
    valid = m > 0
    torch.testing.assert_close(lse[valid], ref_lse[valid], atol=1e-5,
                               rtol=0)
    psum = torch.exp2(_logits_plain(q, k, compat, m) - lse[..., None]).sum(-1)
    torch.testing.assert_close(psum[valid], torch.ones_like(psum[valid]),
                               atol=1e-5, rtol=0)

    ref = compat_attention_bwd_plain(q, k, v, do, out.detach(), lse, m, src,
                                     tgt, 0.10, compat=cache)
    assert (got[0][~valid] == 0).all()
    for g, r in zip(got, ref):
        scale = r.float().abs().max().item()
        atol = (1e-5 * scale if dtype == torch.float32
                else 4 * _bf16_ulp(scale))
        torch.testing.assert_close(g.float(), r.float(), atol=atol, rtol=0)
    # the wrapper on its own gives the same gradients as autograd did
    again = compat_flash_attention_bwd(q, k, v, do, out.detach(), lse, m,
                                       src, tgt, 0.10, compat=cache)
    for g, a in zip(got, again):
        assert torch.equal(g, a)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,k,C", [(37, 40, 128), (13, 10, 32)])
def test_seed_solver_kernel(gen, cuda, dtype, S, k, C):
    """Weights to 1e-5 absolute (they are ~1/k; the kernel rescales by the
    largest entry per round where the plain version divides by the norm,
    and sums in another order); the transforms from them within rotation
    5e-4 and translation 5e-3."""
    B = 2
    f = gen.randn(B, S, k, C).astype(np.float32)
    f /= np.linalg.norm(f, axis=-1, keepdims=True)
    src = (gen.rand(B, S, k, 3) * 3).astype(np.float32)
    tgt = src + np.array([0.2, -0.1, 0.4], np.float32)
    tgt = tgt + 0.02 * gen.randn(B, S, k, 3).astype(np.float32)
    out = gen.rand(B, S, k) < 0.33
    tgt = np.where(out[..., None], gen.rand(B, S, k, 3) * 3, tgt)
    f, src, tgt = (_t(f, cuda).to(dtype), _t(src, cuda),
                   _t(tgt.astype(np.float32), cuda))
    sigma = torch.tensor([1.2], device=cuda)
    before = _build.launches["fused_seed_weights"]
    got = fused_seed_weights(f, src, tgt, sigma, 0.10)
    assert _build.launches["fused_seed_weights"] == before + 1
    ref = fused_seed_weights_plain(f, src, tgt, sigma, 0.10)
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=0)
    T = fused_seed_transforms(f, src, tgt, sigma, 0.10)
    from gmf_tpu_torch.geometry.kabsch import rigid_transform_3d
    T_ref = rigid_transform_3d(src.reshape(-1, k, 3), tgt.reshape(-1, k, 3),
                               ref.reshape(-1, k)).reshape(B, S, 4, 4)
    torch.testing.assert_close(T[..., :3, :3], T_ref[..., :3, :3],
                               atol=5e-4, rtol=0)
    torch.testing.assert_close(T[..., :3, 3], T_ref[..., :3, 3], atol=5e-3,
                               rtol=0)


def test_nms_kernel(gen, cuda):
    pts = _t((gen.rand(2, 1000, 3) * 2).astype(np.float32), cuda)
    sc = _t(gen.rand(2, 1000).astype(np.float32), cuda)
    sc[0, :50] = sc[0, 50:100]  # equal scores never suppress
    torch.testing.assert_close(nms_local_max(pts, sc, 0.1),
                               nms_local_max_plain(pts, sc, 0.1),
                               atol=0, rtol=0)


@pytest.mark.parametrize("case", ["plain", "ties", "exhausted"])
def test_knn_kernel(gen, cuda, case):
    """Indices exact; scores to f32 summation-order error."""
    B, S, N, C, k = 2, 50, 1000, 128, 41
    f = gen.randn(B, N, C).astype(np.float32)
    f /= np.linalg.norm(f, axis=-1, keepdims=True)
    mask = np.ones((B, N), np.float32)
    if case == "ties":
        f[:, 500:600] = f[:, :100]
    if case == "exhausted":
        mask[0, 30:] = 0.0
    f, m = _t(f, cuda), _t(mask, cuda)
    s = f[:, :S].contiguous()
    got_i, got_v = seed_knn_topk(s, f, k, mask=m)
    ref_i, ref_v = seed_knn_topk_plain(s, f, k, mask=m)
    torch.testing.assert_close(got_i, ref_i, atol=0, rtol=0)
    torch.testing.assert_close(got_v, ref_v, atol=1e-5, rtol=0)


def test_scoring_kernel(gen, cuda):
    B, S, N = 2, 60, 2000
    src = gen.rand(B, N, 3).astype(np.float32) * 3
    T = np.tile(np.eye(4, dtype=np.float32), (B, S, 1, 1))
    T[:, :, :3, 3] = 0.05 * gen.randn(B, S, 3)
    tgt = src + 0.08 * gen.randn(B, N, 3).astype(np.float32)
    mask = np.ones((B, N), np.float32)
    mask[1, 1500:] = 0.0
    args = [_t(x, cuda) for x in (T, src, tgt)]
    m = _t(mask, cuda)
    got = seed_hypothesis_counts(*args, 0.10, mask=m)
    ref = seed_hypothesis_counts_plain(*args, 0.10, mask=m)
    # the two residual forms round differently only at the knife edge
    assert (got - ref).abs().max().item() <= 2


_SLICE_LAUNCHES = {
    # mode: launches of (streaming, build+attend, cached, standalone cache)
    "off": (2, 0, 0, 0), "int8": (0, 1, 1, 0), "f32": (0, 0, 2, 1),
    "bf16": (0, 0, 2, 1), "auto": (0, 0, 2, 1),  # auto: f32 at this size
}


@pytest.mark.parametrize("seed_solver", ["xla", "fused"])
@pytest.mark.parametrize("mode", list(_SLICE_LAUNCHES))
def test_small_slice_kernels_vs_plain_on_cpu(cuda, mode, seed_solver):
    """A 2-layer f32 model served on the card (kernels) and on the CPU
    (plain versions), same weights and inputs, in every compat_cache
    mode; "auto" on the CPU is the streaming path, so it is held against
    the CPU's f32-cache model."""
    kw = dict(num_layers=2, num_channels=32, k=10, seed_solver=seed_solver)
    gpu = PointDSC(device="cuda", compat_cache=mode, **kw)
    cpu = PointDSC(device="cpu",
                   compat_cache="f32" if mode == "auto" else mode, **kw)
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    prob = make_correspondence_problem(np.random.RandomState(0),
                                       num_corr=400, inlier_ratio=0.5,
                                       image_hw=(32, 32), batch=2)
    samples = [{k: v[b] for k, v in prob.items()} for b in range(2)]
    _build.reset_launches()
    got = PointDSCRegistrar(gpu, buckets=(512,)).register_batch(samples)
    assert tuple(_build.launches[n] for n in (
        "compat_flash_attention", "compat_flash_attention_build",
        "compat_flash_attention_cached", "build_compat_cache")
    ) == _SLICE_LAUNCHES[mode]
    assert min(_build.launches[n] for n in (
        "nms_local_max", "seed_knn_topk", "seed_hypothesis_counts")) == 1
    assert _build.launches["fused_seed_weights"] == (seed_solver == "fused")
    ref = PointDSCRegistrar(cpu, buckets=(512,)).register_batch(samples)
    for (tg, lg), (tr, lr) in zip(got, ref):
        np.testing.assert_allclose(tg, tr, atol=1e-3)
        assert (lg == lr).mean() >= 0.99
