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
    _cached_forward, _check_qkv, _load_compat, _logits_plain, _stream_compat_plain,
    _streaming_forward, build_compat_cache, bwd_dkv, bwd_dq, bwd_inputs,
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
from gmf_tpu_torch.ops.fused_topk import KERNELS as KNN_KERNELS
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
    """N=333 is no multiple of any block or key tile. f32: summation order
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


def _cache_checks(got, ref, N):
    """Every byte equal to the plain version's, equal to its transpose over
    [:N, :N] (the kernel computes each tile pair once and stores the tile
    and its transpose), pad columns 0."""
    assert got.shape == ref.shape and got.dtype == ref.dtype
    assert torch.equal(got, ref)
    assert torch.equal(got[:, :, :N], got[:, :, :N].transpose(1, 2))
    assert not got[:, :, N:].any()


@pytest.mark.parametrize("extent", [2.5, 120.0])
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("N", [1, 2, 63, 64, 65, 127, 128, 129, 333, 1000])
def test_build_compat_cache_kernel_edges(gen, cuda, N, dtype, B, extent):
    """Around the 64-entry tiles (a lone diagonal tile, ragged last row and
    column tiles, pad columns in the last column tile): every byte against
    the plain version, symmetric, pads 0, two launches equal, one launch
    counted per call."""
    src = gen.rand(B, N, 3).astype(np.float32) * extent
    tgt = src + 0.02 * extent * gen.randn(B, N, 3).astype(np.float32)
    tgt[:, ::3] = gen.rand(B, (N + 2) // 3, 3).astype(np.float32) * extent
    src, tgt = _t(src, cuda), _t(tgt, cuda)
    sigma_d = 0.10 if extent < 10 else 1.2
    before = _build.launches["build_compat_cache"]
    got = build_compat_cache(src, tgt, sigma_d, dtype)
    again = build_compat_cache(src, tgt, sigma_d, dtype)
    assert _build.launches["build_compat_cache"] == before + 2
    _cache_checks(got, build_compat_cache_plain(src, tgt, sigma_d, dtype), N)
    assert torch.equal(got, again)


def test_build_compat_cache_pair_boundary(gen, cuda):
    """Pair 0 (N = 333) next to a pair whose keypoints are all inf: its
    last tiles must not read them, so pair 0's cache equals its plain
    cache computed alone, in each type."""
    N = 333
    src = gen.rand(2, N, 3).astype(np.float32) * 2.5
    tgt = src + 0.02 * gen.randn(2, N, 3).astype(np.float32)
    src[1], tgt[1] = np.inf, np.inf
    src, tgt = _t(src, cuda), _t(tgt, cuda)
    for dtype in (torch.float32, torch.bfloat16, torch.int8):
        got = build_compat_cache(src, tgt, 0.10, dtype)
        _cache_checks(got[:1], build_compat_cache_plain(src[:1], tgt[:1],
                                                        0.10, dtype), N)


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
    blocks or key tiles), pair 0 partly masked, against
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


# the bf16 forward core's modes (compat_flash_fwd_tc in
# csrc/compat_flash_core.cuh): streaming, build+attend, cached on each
# cache type, no compat (variant v1)
_CORE_MODES = ["stream", "build", "cached_int8", "cached_bf16",
               "cached_f32", "none"]
_CACHE_OF = {"cached_int8": torch.int8, "cached_bf16": torch.bfloat16,
             "cached_f32": torch.float32}


def _core_inputs(gen, cuda, B, N, D, dtype=torch.bfloat16):
    """q, k, v of ``dtype`` and keypoints; pair 0 has masked keys inside
    its 64-key tiles (keys 20..39 of each, and every index 3 mod 7), pair
    1 has every key masked, pair 2 none."""
    q, k, v = (_t(gen.randn(B, N, D).astype(np.float32), cuda)
               .to(dtype) for _ in range(3))
    src = gen.rand(B, N, 3).astype(np.float32) * 2.5
    tgt = src + 0.02 * gen.randn(B, N, 3).astype(np.float32)
    tgt[:, ::3] = gen.rand(B, (N + 2) // 3, 3).astype(np.float32) * 2.5
    mask = np.ones((B, N), np.float32)
    j = np.arange(N)
    mask[0, ((j % 64 >= 20) & (j % 64 < 40)) | (j % 7 == 3)] = 0.0
    mask[1] = 0.0
    return q, k, v, _t(src, cuda), _t(tgt, cuda), _t(mask, cuda)


def _core_run(mode, q, k, v, src, tgt, m):
    """One launch of the forward core in ``mode``: (out, lse or None,
    the cache it built or read, or None)."""
    if mode == "stream":
        return (*_streaming_forward(q, k, v, src, tgt, m, 0.10, True), None)
    if mode == "build":
        out, cache = compat_flash_attention_build(q, k, v, src, tgt, mask=m)
        return out, None, cache
    if mode in _CACHE_OF:
        cache = build_compat_cache(src, tgt, 0.10, _CACHE_OF[mode])
        return (*_cached_forward(q, k, v, cache, m, True), cache)
    variant = "v1" if mode == "none" else mode
    return flash_variant(q, k, v, src, tgt, mask=m, variant=variant), None, \
        None


def _core_check(mode, q, k, v, src, tgt, m, p=slice(None)):
    """The kernel against its plain version on pairs ``p``: the output
    within 2 bf16 ulps of the largest one (both round q*scale and p to
    bf16, then the output) or, in f32, within 1e-5 (the three-term split
    and another summation order), the lse (where the kernel writes one)
    within 1e-5 on every row of a pair with a valid key (summation order);
    build+attend's cache equal to the plain one in every byte and its
    output to the cached kernel's on it. Returns the kernel's (out, lse)
    on pairs ``p``."""
    out, lse, cache = _core_run(mode, q, k, v, src, tgt, m)
    ref_lse = None
    if mode == "stream":
        ref, ref_lse = compat_attention_plain(q[p], k[p], v[p], src[p],
                                              tgt[p], m[p], return_lse=True)
    elif mode == "build":
        ref_cache = build_compat_cache_plain(src, tgt, 0.10, torch.int8)
        assert torch.equal(cache, ref_cache)
        cached = compat_flash_attention(q, k, v, None, None, mask=m,
                                        compat=cache)
        assert torch.equal(out[p], cached[p])
        ref = compat_attention_cached_plain(q[p], k[p], v[p], ref_cache[p],
                                            mask=m[p])
    elif mode in _CACHE_OF:
        ref, ref_lse = compat_attention_cached_plain(
            q[p], k[p], v[p], cache[p], m[p], return_lse=True)
    else:
        variant = "v1" if mode == "none" else mode
        ref = flash_variant_plain(q[p], k[p], v[p], src[p], tgt[p],
                                  mask=m[p], variant=variant)
    assert out.dtype == q.dtype
    torch.testing.assert_close(out[p].float(), ref.float(),
                               atol=_out_atol(ref, q.dtype), rtol=0)
    if lse is not None:
        rows = ref_lse > -1e8  # a pair with every key masked: -1e9
        torch.testing.assert_close(lse[p][rows], ref_lse[rows], atol=1e-5,
                                   rtol=0)
    return out[p], None if lse is None else lse[p]


@pytest.mark.parametrize("N", [1, 63, 64, 65, 127, 128, 129, 333, 5000])
@pytest.mark.parametrize("D", [32, 128])
@pytest.mark.parametrize("mode", _CORE_MODES)
def test_bf16_core_edges(gen, cuda, mode, D, N):
    """Key counts below, at and around one 64-key tile (beside a bf16 or
    f32 cache) and one 128-key tile and 128-row query block, a ragged 333
    and the bench's 5000; masked keys inside a tile and a fully masked
    pair."""
    _core_check(mode, *_core_inputs(gen, cuda, 3, N, D))


def test_bf16_core_rejects_misaligned(gen, cuda):
    """The bf16 forward kernels copy 16-byte chunks: a q/k/v view that
    starts off a 16-byte boundary is refused by every forward wrapper
    before the launch, not read wrongly. The backward's check takes such a
    view, and ``bwd_inputs`` copies it to aligned storage before the cached
    kernels' 16-byte loads: the gradients equal those of an aligned q."""
    q, k, v, src, tgt, m = _core_inputs(gen, cuda, 3, 64, 32)
    flat = torch.zeros(q.numel() + 1, dtype=q.dtype, device=cuda)
    shifted = flat[1:].view(q.shape)
    shifted.copy_(q)
    cache = build_compat_cache(src, tgt, 0.10, torch.int8)
    for forward in (
            lambda: compat_flash_attention(shifted, k, v, src, tgt, mask=m),
            lambda: compat_flash_attention(shifted, k, v, None, None,
                                           mask=m, compat=cache),
            lambda: compat_flash_attention_build(shifted, k, v, src, tgt,
                                                 mask=m),
            lambda: flash_variant(shifted, k, v, src, tgt, mask=m,
                                  variant="v1")):
        with pytest.raises(ValueError, match="aligned"):
            forward()
    assert _check_qkv("backward", shifted, k, v)[0].data_ptr() == \
        shifted.data_ptr()
    out, lse = _cached_forward(q, k, v, cache, m, True)
    do = torch.ones_like(q)
    got = compat_flash_attention_bwd(shifted, k, v, do, out, lse, m,
                                     compat=cache)
    ref = compat_flash_attention_bwd(q, k, v, do, out, lse, m, compat=cache)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


@pytest.mark.parametrize("D", [32, 128])
@pytest.mark.parametrize("mode", _CORE_MODES)
def test_bf16_core_pair_boundary(gen, cuda, mode, D):
    """Pair 0's last tile (N = 333) reaches 51 rows into pair 1, whose k
    and v are all inf: the kernel must not read them, so pair 0's output
    and lse equal the plain version's on pair 0 alone."""
    q, k, v, src, tgt, _ = _core_inputs(gen, cuda, 2, 333, D)
    k[1], v[1] = float("inf"), float("inf")
    m = torch.ones(2, 333, device=cuda)
    _core_check(mode, q, k, v, src, tgt, m, slice(0, 1))


# the f32 forward core (compat_flash_fwd_split): every mode, the variant
# instances of the microbenchmark (v0, v3, v6) too
_F32_CORE_MODES = _CORE_MODES + ["v0", "v3", "v6"]


def _f32_core_check(mode, q, k, v, src, tgt, m, p=slice(None)):
    """_core_check in f32, and: each valid row's p = exp2(s - lse) sums to
    1 within 1e-5 (the backward recomputes p from this lse); a second
    launch gives the same bits."""
    out, lse = _core_check(mode, q, k, v, src, tgt, m, p)
    again, again_lse, _ = _core_run(mode, q, k, v, src, tgt, m)
    assert torch.equal(again[p], out)
    if lse is None:
        return
    assert torch.equal(again_lse[p], lse)
    if mode == "stream":
        compat = _stream_compat_plain(src[p], tgt[p], 0.10)
    else:
        compat = _load_compat(build_compat_cache(src[p], tgt[p], 0.10,
                                                 _CACHE_OF[mode]),
                              q.shape[1])
    valid = m[p] > 0
    if not valid.any():
        return
    rows = valid.any(-1, keepdim=True).expand_as(valid)
    psum = torch.exp2(_logits_plain(q[p], k[p], compat, m[p])
                      - lse[..., None]).sum(-1)
    torch.testing.assert_close(psum[rows], torch.ones_like(psum[rows]),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("N", [1, 65, 333, 1000])
@pytest.mark.parametrize("D", [32, 128])
@pytest.mark.parametrize("mode", _F32_CORE_MODES)
def test_f32_core_edges(gen, cuda, mode, D, N):
    """The f32 forward core on the tensor cores: one key, one past a
    64-row block, a ragged 333 and the training shape's 1000 (no multiple
    of the 32-key slots); masked keys inside the tiles of pair 0, a fully
    masked pair 1, pair 2 without a mask. Output and lse within 1e-5, p
    summing to 1, two launches equal in every bit, build+attend's cache
    equal to the plain one in every byte and its output to the cached
    kernel's on it in every bit."""
    _f32_core_check(mode, *_core_inputs(gen, cuda, 3, N, D, torch.float32))


@pytest.mark.parametrize("D", [32, 128])
@pytest.mark.parametrize("mode", _F32_CORE_MODES)
def test_f32_core_pair_boundary(gen, cuda, mode, D):
    """Pair 0's last tile (N = 333) reaches 19 rows into pair 1, whose k
    and v are all inf: the f32 kernel must not read them."""
    q, k, v, src, tgt, _ = _core_inputs(gen, cuda, 2, 333, D, torch.float32)
    k[1], v[1] = float("inf"), float("inf")
    m = torch.ones(2, 333, device=cuda)
    _f32_core_check(mode, q, k, v, src, tgt, m, slice(0, 1))


def test_f32_core_copies_misaligned(gen, cuda):
    """The f32 forward kernels load q, k and v 16 bytes at a time: every
    forward wrapper copies a view that starts off a 16-byte boundary to
    fresh storage before the launch, and gives the aligned input's
    output in every bit."""
    q, k, v, src, tgt, m = _core_inputs(gen, cuda, 3, 333, 128,
                                        torch.float32)
    flat = torch.zeros(3, q.numel() + 1, device=cuda)
    shifted = [f[1:].view(q.shape) for f in flat]
    for s, x in zip(shifted, (q, k, v)):
        s.copy_(x)
        assert s.data_ptr() % 16
    for mode in _F32_CORE_MODES:
        got = _core_run(mode, *shifted, src, tgt, m)
        ref = _core_run(mode, q, k, v, src, tgt, m)
        for g, r in zip(got, ref):
            assert (g is None) == (r is None)
            if g is not None:
                assert torch.equal(g, r)


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


def _bwd_case(gen, cuda, B, N, D, dtype):
    """q, k, v, do of ``dtype`` and keypoints; the mask of _core_inputs:
    pair 0 with masked keys inside every tile, pair 1 (if any) all
    masked, the others none."""
    q, k, v, do = (_t(gen.randn(B, N, D).astype(np.float32), cuda).to(dtype)
                   for _ in range(4))
    src = gen.rand(B, N, 3).astype(np.float32) * 2.5
    tgt = src + 0.02 * gen.randn(B, N, 3).astype(np.float32)
    mask = np.ones((B, N), np.float32)
    j = np.arange(N)
    mask[0, ((j % 64 >= 20) & (j % 64 < 40)) | (j % 7 == 3)] = 0.0
    if B > 1:
        mask[1] = 0.0
    return q, k, v, do, _t(src, cuda), _t(tgt, cuda), _t(mask, cuda)


def _bwd_check(q, k, v, do, src, tgt, m, cache_dtype, p=slice(None)):
    """The dK/dV and dQ kernels (csrc/compat_flash_bwd_tc.cuh), streaming
    (``cache_dtype`` None: compat from the keypoints) or cached, on the
    forward kernel's out and lse, against the plain backward on pairs
    ``p``: f32 within 1e-5 of the largest entry (the three-term bf16 split
    and another summation order), bf16 within 4 bf16 ulps of it; masked
    query rows get a dq of exactly 0; a second launch gives the same bits
    on those pairs."""
    if cache_dtype is None:
        cache = None
        out, lse = _streaming_forward(q, k, v, src, tgt, m, 0.10, True)
        names = ("compat_flash_attention_bwd_dkv",
                 "compat_flash_attention_bwd_dq")
    else:
        cache = build_compat_cache(src, tgt, 0.10, cache_dtype)
        out, lse = _cached_forward(q, k, v, cache, m, True)
        names = ("compat_flash_attention_cached_bwd_dkv",
                 "compat_flash_attention_cached_bwd_dq")
    inp = bwd_inputs(q, k, v, do, out, lse, m)

    def run():
        return (bwd_dq(inp, src, tgt, 0.10, cache),
                *bwd_dkv(inp, src, tgt, 0.10, cache))

    _build.reset_launches()
    got = run()
    assert [_build.launches[n] for n in names] == [1, 1]
    again = run()
    for g, a in zip(got, again):
        assert torch.equal(g[p], a[p])
    assert (got[0][p][m[p] == 0] == 0).all()
    refs = compat_attention_bwd_plain(
        q[p], k[p], v[p], do[p], out[p], lse[p], m[p], src[p], tgt[p], 0.10,
        compat=None if cache is None else cache[p])
    for g, r in zip(got, refs):
        scale = r.float().abs().max().item()
        atol = (1e-5 * scale if q.dtype == torch.float32
                else 4 * _bf16_ulp(scale))
        torch.testing.assert_close(g[p].float(), r.float(), atol=atol,
                                   rtol=0)


@pytest.mark.parametrize("cache_dtype",
                         [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N", [65, 333, 1000])
@pytest.mark.parametrize("D", [32, 128])
def test_cached_backward_edges(gen, cuda, D, N, dtype, cache_dtype):
    """Key and query counts one past a 64-row block, a ragged 333 and the
    training shape's 1000 (no multiple of the 32-row slots); masked keys
    inside the tiles of pair 0, a fully masked pair 1 (every gradient 0),
    pair 2 without a mask."""
    _bwd_check(*_bwd_case(gen, cuda, 3, N, D, dtype), cache_dtype)


@pytest.mark.parametrize("cache_dtype",
                         [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [32, 128])
def test_cached_backward_pair_boundary(gen, cuda, D, dtype, cache_dtype):
    """Pair 0's last tiles (N = 333) reach into pair 1, whose k, v and do
    are all inf: the kernels must not read them, so pair 0's gradients
    meet the limits against the plain backward on pair 0 alone."""
    q, k, v, do, src, tgt, _ = _bwd_case(gen, cuda, 2, 333, D, dtype)
    for t in (k, v, do):
        t[1] = float("inf")
    m = torch.ones(2, 333, device=cuda)
    _bwd_check(q, k, v, do, src, tgt, m, cache_dtype, slice(0, 1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N", [65, 333, 1000])
@pytest.mark.parametrize("D", [32, 128])
def test_streaming_backward_edges(gen, cuda, D, N, dtype):
    """The streaming kernels, compat rebuilt per tile from the keypoints,
    at the cached edges' counts and masks: one past a 64-row block, a
    ragged 333, the training shape's 1000; masked keys inside the tiles
    of pair 0, a fully masked pair 1, pair 2 without a mask."""
    _bwd_check(*_bwd_case(gen, cuda, 3, N, D, dtype), None)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [32, 128])
def test_streaming_backward_pair_boundary(gen, cuda, D, dtype):
    """Pair 0's last tiles (N = 333) reach into pair 1, whose k, v, do and
    keypoints are all inf: the streaming kernels must not read them, so
    pair 0's gradients meet the limits against the plain backward on pair
    0 alone."""
    q, k, v, do, src, tgt, _ = _bwd_case(gen, cuda, 2, 333, D, dtype)
    for t in (k, v, do, src, tgt):
        t[1] = float("inf")
    m = torch.ones(2, 333, device=cuda)
    _bwd_check(q, k, v, do, src, tgt, m, None, slice(0, 1))


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


def _solver_case(gen, cuda, B, S, k, C, dtype):
    f = gen.randn(B, S, k, C).astype(np.float32)
    f += 1.5 * gen.randn(B, S, 1, C).astype(np.float32)  # related features
    f /= np.linalg.norm(f, axis=-1, keepdims=True)
    src = (gen.rand(B, S, k, 3) * 3).astype(np.float32)
    tgt = src + np.array([0.2, -0.1, 0.4], np.float32)
    tgt = tgt + 0.02 * gen.randn(B, S, k, 3).astype(np.float32)
    out = gen.rand(B, S, k) < 0.33
    tgt = np.where(out[..., None], gen.rand(B, S, k, 3) * 3, tgt)
    return (_t(f, cuda).to(dtype), _t(src, cuda),
            _t(tgt.astype(np.float32), cuda))


def _solver_check(f, src, tgt, sigma=1.2):
    """One launch counted; weights within 1e-5 of the plain version, the
    transforms from them within rotation 5e-4 and translation 5e-3 of
    those from the plain weights (test_seed_solver_kernel's limits)."""
    from gmf_tpu_torch.geometry.kabsch import rigid_transform_3d

    B, S, k, _ = f.shape
    sig = torch.tensor([sigma], device=f.device)
    before = _build.launches["fused_seed_weights"]
    got = fused_seed_weights(f, src, tgt, sig, 0.10)
    assert _build.launches["fused_seed_weights"] == before + 1
    ref = fused_seed_weights_plain(f, src, tgt, sig, 0.10)
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=0)

    def trans(w):
        return rigid_transform_3d(src.reshape(-1, k, 3),
                                  tgt.reshape(-1, k, 3), w.reshape(-1, k))

    T, T_ref = trans(got), trans(ref)
    torch.testing.assert_close(T[:, :3, :3], T_ref[:, :3, :3], atol=5e-4,
                               rtol=0)
    torch.testing.assert_close(T[:, :3, 3], T_ref[:, :3, 3], atol=5e-3,
                               rtol=0)
    return got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", [16, 32, 128])
@pytest.mark.parametrize("k", [1, 10, 17, 40, 64, 128])
def test_seed_solver_kernel_shapes(gen, cuda, k, C, dtype):
    """Every instance of the tensor-core kernel (k padded to 16, 32, 48,
    64, and the one-row-tile-a-pass instance past 64) and chunk edges of
    C, against the plain version."""
    got = _solver_check(*_solver_case(gen, cuda, 2, 13, k, C, dtype))
    if k > 1:
        assert got.max().item() > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_seed_solver_kernel_ragged_and_misaligned(gen, cuda, dtype):
    """C = 20 and C = 129 (rows not 16-byte aligned: element loads), and
    features starting past a 16-byte boundary: the same limits, and the
    misaligned features give the aligned ones' weights in every bit."""
    for C in (20, 129):
        _solver_check(*_solver_case(gen, cuda, 2, 9, 40, C, dtype))
    f, src, tgt = _solver_case(gen, cuda, 2, 9, 40, 128, dtype)
    want = _solver_check(f, src, tgt)
    buf = torch.empty(f.numel() + 1, dtype=dtype, device=f.device)
    buf[1:] = f.reshape(-1)
    shifted = buf[1:].view(f.shape)
    assert shifted.data_ptr() % 16 != 0
    assert torch.equal(_solver_check(shifted, src, tgt), want)


def test_nms_kernel(gen, cuda):
    pts = _t((gen.rand(2, 1000, 3) * 2).astype(np.float32), cuda)
    sc = _t(gen.rand(2, 1000).astype(np.float32), cuda)
    sc[0, :50] = sc[0, 50:100]  # equal scores never suppress
    torch.testing.assert_close(nms_local_max(pts, sc, 0.1),
                               nms_local_max_plain(pts, sc, 0.1),
                               atol=0, rtol=0)


# b=64 x 5000 (the serving path), ragged N, and past one run of the
# kernel's sort (16384 points): two runs, and three (two merge passes)
@pytest.mark.parametrize("B,N", [(64, 5000), (3, 333), (2, 1), (2, 129),
                                 (1, 16385), (1, 33000)])
def test_nms_kernel_sweep_edges(gen, cuda, B, N):
    """The x sweep (csrc/nms_local_max.cu) at the serving path's b=64, at
    ragged N, and past the points one block of its sort takes (there its
    runs are merged): a third of the points on a lattice of half the
    radius (pairs at exactly the radius, which do not suppress; many
    equal x), scores from 20 values (ties never suppress), the last
    pair's scores negative, and in pair 0 of the ragged sizes a
    non-finite point (NaN and +inf x: never suppressed, never
    suppressing). Equal to the plain version in every bit, one launch a
    call; the sort orders each pair by x, ties by index, NaN last (no x
    here is -0 or a negative NaN), and packs (x, y, z, score)."""
    radius = 0.25
    pts = (gen.rand(B, N, 3) * 3).astype(np.float32)
    lattice = gen.randint(0, 6, size=(B, N // 3, 3)).astype(np.float32)
    pts[:, : N // 3] = lattice * (radius / 2)
    scores = gen.randint(0, 20, size=(B, N)).astype(np.float32) / 20
    scores[-1] -= 0.5
    if B < 64 and N > 2:
        pts[0, 1, 0], pts[0, 2, 0] = np.nan, np.inf
    pts, scores = _t(pts, cuda), _t(scores, cuda)
    before = _build.launches["nms_local_max"]
    got = nms_local_max(pts, scores, radius)
    assert _build.launches["nms_local_max"] == before + 1
    ref = torch.cat([nms_local_max_plain(pts[s0:s0 + 8], scores[s0:s0 + 8],
                                         radius) for s0 in range(0, B, 8)])
    assert torch.equal(got, ref)
    keys = torch.empty(B, N, 4, device=cuda)
    order = torch.empty(B, N, dtype=torch.int32, device=cuda)
    assert _build.load().gmf_nms_sort(
        pts.data_ptr(), scores.data_ptr(), keys.data_ptr(), order.data_ptr(),
        B, N, torch.cuda.current_stream().cuda_stream) == 0
    want = torch.sort(pts[..., 0], dim=1, stable=True).indices
    packed = torch.cat([pts, scores[..., None]], dim=-1)
    assert torch.equal(order.long(), want)
    assert torch.equal(keys.nan_to_num(), torch.take_along_dim(
        packed, want[..., None], dim=1).nan_to_num())


# (N, S, k) per case: N past a multiple of the 64-key tile (1000, 333, 65),
# S past a multiple of the 64-seed block (50, 1, 65), k at both list widths
KNN_CASES = {
    "plain": (1000, 50, 41),
    "ties": (1000, 50, 64),        # duplicated rows; exact zero scores
    "exhausted": (1000, 50, 41),   # pair 0: 30 valid keys < k
    "all_masked": (333, 50, 41),   # pair 1: no valid key
    "boundary": (65, 1, 64),       # pair 1's features all +inf
    "k128": (1000, 65, 128),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(KNN_CASES))
def test_knn_kernel(gen, cuda, case, dtype):
    """Indices equal to the plain version's; scores within 1e-5 (f32
    summation order; bf16 products are exact). The plain version gets
    the same bf16 values."""
    N, S, k = KNN_CASES[case]
    B, C = 2, 128
    f = gen.randn(B, N, C).astype(np.float32)
    f /= np.linalg.norm(f, axis=-1, keepdims=True)
    mask = np.ones((B, N), np.float32)
    if case == "ties":
        # the seeds (rows 0-49) and their copies (500-549) live in the
        # first half of the depth, every other row in the second: those
        # score exactly 0 (+0 and -0 compare equal) and fill by index
        f[:, :50, C // 2:] = 0.0
        f[:, 50:, : C // 2] = 0.0
        f[:, 500:550] = f[:, :50]
    if case == "exhausted":
        mask[0, 30:] = 0.0
    if case == "all_masked":
        mask[1] = 0.0
    if case == "boundary":
        f[1] = np.inf
    f, m = _t(f, cuda).to(dtype), _t(mask, cuda)
    s = f[:, :S].contiguous()
    name = ("seed_knn_topk_bf16" if dtype == torch.bfloat16
            else "seed_knn_topk_f32")
    before = _build.launches[name]
    got_i, got_v = seed_knn_topk(s, f, k, mask=m)
    ref_i, ref_v = seed_knn_topk_plain(s, f, k, mask=m)
    assert _build.launches[name] == before + 1
    pairs = slice(0, 1) if case == "boundary" else slice(None)
    torch.testing.assert_close(got_i[pairs], ref_i[pairs], atol=0, rtol=0)
    torch.testing.assert_close(got_v[pairs], ref_v[pairs], atol=1e-5,
                               rtol=0)
    if case == "ties":
        assert (ref_v == 0).sum() > S and (got_i[..., 1] >= 500).all()


def test_knn_kernel_refuses(cuda):
    """k > N and k past the list width raise; so does a depth above 128."""
    f = torch.randn(1, 200, 128, device=cuda)
    with pytest.raises(ValueError, match="N=40"):
        seed_knn_topk(f[:, :5], f[:, :40], 41)
    with pytest.raises(ValueError, match="top-k width"):
        seed_knn_topk(f[:, :5], f, 129)
    with pytest.raises(ValueError, match="depth"):
        seed_knn_topk(torch.randn(1, 5, 256, device=cuda),
                      torch.randn(1, 300, 256, device=cuda), 41)


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
    # the kernel and the plain version form the residual with the same
    # rounded operations in the same order: every count equal
    assert torch.equal(got, ref)


def _scoring_case(gen, cuda, B, S, N, extent=3.0):
    """Hypotheses near the identity (turned ~0.05 rad, shifted ~5 cm),
    src in a cube of side ``extent``, tgt = src + 8 cm gaussian; pair b's
    points from N - 37 b on masked, and a tenth of the others at random."""
    src = (gen.rand(B, N, 3) * extent).astype(np.float32)
    a = 0.05 * gen.randn(B, S)
    T = np.tile(np.eye(4, dtype=np.float32), (B, S, 1, 1))
    T[..., 0, 0], T[..., 0, 1] = np.cos(a), -np.sin(a)
    T[..., 1, 0], T[..., 1, 1] = np.sin(a), np.cos(a)
    T[..., :3, 3] = 0.05 * gen.randn(B, S, 3)
    tgt = (src + 0.08 * gen.randn(B, N, 3)).astype(np.float32)
    mask = (gen.rand(B, N) > 0.1).astype(np.float32)
    mask[np.arange(N)[None] >= N - 37 * np.arange(B)[:, None]] = 0.0
    return (_t(T, cuda), _t(src, cuda), _t(tgt, cuda), _t(mask, cuda))


def _counts_check(T, src, tgt, m, thr=0.10, pairs=8):
    """One launch counted, equal to the plain version (run on ``pairs``
    pairs at a time) in every count, and a second launch equal to the
    first."""
    before = _build.launches["seed_hypothesis_counts"]
    got = seed_hypothesis_counts(T, src, tgt, thr, mask=m)
    assert _build.launches["seed_hypothesis_counts"] == before + 1
    assert got.dtype == torch.int32 and got.shape == T.shape[:2]
    ref = torch.cat([seed_hypothesis_counts_plain(
        T[b:b + pairs], src[b:b + pairs], tgt[b:b + pairs], thr,
        mask=None if m is None else m[b:b + pairs])
        for b in range(0, T.shape[0], pairs)])
    assert torch.equal(got, ref)
    assert torch.equal(seed_hypothesis_counts(T, src, tgt, thr, mask=m), got)
    return got


@pytest.mark.parametrize("N", [1, 333, 5000])
@pytest.mark.parametrize("S", [1, 7, 9, 500])
def test_scoring_kernel_edges(gen, cuda, S, N):
    """Seed counts around the kernel's 4 seeds a thread and 512 a block,
    point counts around its chunks: equal to the plain version in every
    count, with and without a mask, and the same counts from two
    launches."""
    T, src, tgt, m = _scoring_case(gen, cuda, 3, S, N)
    got = _counts_check(T, src, tgt, m)
    _counts_check(T, src, tgt, None)
    if N > 1:
        assert int(got.max()) > 0


def test_scoring_kernel_masked_pair_and_boundary(gen, cuda):
    """A pair whose points are all masked counts 0; a pair whose points
    (src and tgt) are all inf counts 0 and leaves its neighbour's counts as
    they are alone (the pair boundary)."""
    T, src, tgt, m = _scoring_case(gen, cuda, 3, 100, 333)
    m[0] = 0.0
    src[2], tgt[2] = float("inf"), float("inf")
    got = _counts_check(T, src, tgt, m)
    assert int(got[0].max()) == 0 and int(got[2].max()) == 0
    alone = seed_hypothesis_counts(T[1:2], src[1:2], tgt[1:2], 0.10,
                                   mask=m[1:2])
    assert torch.equal(got[1:2], alone) and int(alone.max()) > 0


def test_scoring_kernel_b64(gen, cuda):
    """The serving path's shape: 64 pairs of N=5000, S=500."""
    T, src, tgt, m = _scoring_case(gen, cuda, 64, 500, 5000)
    _counts_check(T, src, tgt, m)


def test_scoring_kernel_misaligned(gen, cuda):
    """src and tgt starting 4 bytes past a 16-byte boundary (their
    staging's first and last floats are loaded one at a time), trans 4
    bytes past one (the wrapper copies it): the same counts."""
    T, src, tgt, m = _scoring_case(gen, cuda, 2, 60, 333)
    want = _counts_check(T, src, tgt, m)

    def shifted(x):
        buf = torch.empty(x.numel() + 1, device=x.device)
        buf[1:] = x.reshape(-1)
        return buf[1:].view(x.shape)

    args = [shifted(x) for x in (T, src, tgt)]
    assert all(a.data_ptr() % 16 == 4 for a in args)
    assert torch.equal(_counts_check(*args, m), want)


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
    # the f32 model's seed kNN takes its f32 instance
    assert min(_build.launches[n] for n in (
        "nms_local_max", KNN_KERNELS[torch.float32],
        "seed_hypothesis_counts")) == 1
    assert _build.launches["fused_seed_weights"] == (seed_solver == "fused")
    ref = PointDSCRegistrar(cpu, buckets=(512,)).register_batch(samples)
    for (tg, lg), (tr, lr) in zip(got, ref):
        np.testing.assert_allclose(tg, tr, atol=1e-3)
        assert (lg == lr).mean() >= 0.99


# -- DGR+GMF (models/dgr.py): no kernel of its own; the card against the
# CPU on the same inputs. Sparse convolutions sum K x Cin products in
# other orders on the two devices: 1e-5 of the output's scale for one
# convolution, 1e-4 for a whole net.

def _dgr_coords(dim, n, extent, seed=0):
    r = np.random.RandomState(seed)
    return np.unique(r.randint(0, extent, (n, dim)).astype(np.int32), axis=0)


@pytest.mark.parametrize("dim", [3, 6])
def test_dgr_sparse_conv_card_vs_cpu(cuda, dim):
    from gmf_tpu_torch.sparse.conv import append_sentinel, sparse_conv
    from gmf_tpu_torch.sparse.kernel_map import build_pyramid

    c = _dgr_coords(dim, 3000, 30 if dim == 3 else 6)
    pyr = build_pyramid(c, 4, conv1_kernel_size=7 if dim == 3 else 3,
                        granule=1024)
    r = np.random.RandomState(1)
    x = torch.tensor(r.randn(pyr.levels[0].cap, 32).astype(np.float32))
    nbr = torch.tensor(pyr.levels[0].self_map)
    w = torch.tensor(r.randn(nbr.shape[0], 32, 48).astype(np.float32))
    ref = sparse_conv(append_sentinel(x), w, nbr)
    got = sparse_conv(append_sentinel(x.to(cuda)), w.to(cuda), nbr.to(cuda))
    np.testing.assert_allclose(got.cpu().numpy(), ref.numpy(),
                               atol=1e-5 * ref.abs().max().item())


def test_dgr_inlier_net_card_vs_cpu(cuda):
    """The full-width 6-D GMF inlier net on 2,000 correspondences."""
    from gmf_tpu_torch.sparse.kernel_map import build_pyramid
    from gmf_tpu_torch.sparse.resunet import GMFInlierNet, pyramid_to_arrays

    torch.manual_seed(0)
    net = GMFInlierNet().eval()
    pyr = build_pyramid(_dgr_coords(6, 2000, 8), 4, conv1_kernel_size=3,
                        granule=2048)
    r = np.random.RandomState(2)
    imgs = [torch.tensor(r.rand(1, 120, 160, 3).astype(np.float32))
            for _ in range(2)]
    feats = torch.ones(pyr.levels[0].cap, 1)
    with torch.no_grad():
        ref = net(feats, pyramid_to_arrays(pyr, "cpu"), *imgs)
        net.to(cuda)
        got = net(feats.to(cuda), pyramid_to_arrays(pyr, cuda),
                  *[i.to(cuda) for i in imgs])
    np.testing.assert_allclose(got.cpu().numpy(), ref.numpy(),
                               atol=1e-4 * ref.abs().max().item())


def test_dgr_se3_refine_card_vs_cpu(cuda):
    """The refinement's stop decided on the card: T within 1e-4 of the
    CPU's (a stop decision may fall an iteration apart, see
    tests/test_torch_dgr.py), the iteration counts within 8."""
    from gmf_tpu_torch.models.dgr import se3_refine

    r = np.random.RandomState(3)
    src = torch.tensor((r.rand(5000, 3) * 2).astype(np.float32))
    ang = 0.3
    R = torch.tensor([[np.cos(ang), -np.sin(ang), 0],
                      [np.sin(ang), np.cos(ang), 0], [0, 0, 1]],
                     dtype=torch.float32)
    tgt = src @ R.T + torch.tensor([0.2, -0.1, 0.3])
    tgt = tgt + 0.002 * torch.tensor(r.randn(5000, 3).astype(np.float32))
    w = torch.tensor(r.rand(5000).astype(np.float32))
    T0 = torch.eye(4)
    kw = dict(break_threshold_ratio=1e-4, quantization_size=0.1)
    T, _, it = se3_refine(src, tgt, w, T0, **kw)
    Tc, _, itc = se3_refine(src.to(cuda), tgt.to(cuda), w.to(cuda),
                            T0.to(cuda), **kw)
    assert abs(int(it) - int(itc)) <= 8 and int(itc) < 1000
    np.testing.assert_allclose(Tc.cpu().numpy(), T.numpy(), atol=1e-4)


@pytest.mark.parametrize("dim,compact", [(3, False), (6, False), (6, True)])
def test_dgr_device_pyramid_card_vs_cpu(cuda, dim, compact):
    """The device builder on the card against the same builder on the CPU,
    every array in every bit (compacted schedules leaf by leaf), with
    negative coordinates; uncompacted also against the native host
    builder."""
    from gmf_tpu_torch.sparse.device_maps import build_pyramid_arrays_device
    from gmf_tpu_torch.sparse.kernel_map import build_pyramid
    from gmf_tpu_torch.sparse.resunet import pyramid_to_arrays

    c = _dgr_coords(dim, 3000, 30 if dim == 3 else 6) - 3
    kw = dict(conv1_kernel_size=7 if dim == 3 else 3, granule=1024,
              compact_conv=compact, compact_dense_frac=0.25)
    got = build_pyramid_arrays_device(c, 4, device=cuda, **kw)
    want = [build_pyramid_arrays_device(c, 4, device="cpu", **kw)]
    if not compact:
        want.append(pyramid_to_arrays(build_pyramid(
            c, 4, conv1_kernel_size=kw["conv1_kernel_size"], granule=1024),
            "cpu"))

    def leaves(x, path=""):
        if isinstance(x, dict):
            for k in sorted(x):
                yield from leaves(x[k], f"{path}/{k}")
        elif isinstance(x, (tuple, list)):
            for i, v in enumerate(x):
                yield from leaves(v, f"{path}[{i}]")
        else:
            yield path, x

    g = dict(leaves(got))
    assert compact == any("_cmp_" in k for k in g)
    for w in want:
        w = dict(leaves(w))
        assert g.keys() == w.keys()
        for k, a in g.items():
            if isinstance(a, torch.Tensor):
                assert a.is_cuda and a.dtype == w[k].dtype, k
                assert torch.equal(a.cpu(), w[k]), k
            else:
                assert a == w[k], k


def test_dgr_compact_conv_card(cuda):
    """The compacted convolution against the dense-map one on the card,
    over each 6-D map of a pyramid built there (down, up and self):
    1e-5 of the output's scale (index_add_'s atomic order and the other
    summation order)."""
    from gmf_tpu_torch.sparse.conv import (append_sentinel, sparse_conv,
                                           sparse_conv_compact)
    from gmf_tpu_torch.sparse.device_maps import build_pyramid_arrays_device

    c = _dgr_coords(6, 3000, 6)
    kw = dict(conv1_kernel_size=3, granule=1024, compact_dense_frac=0.25)
    dense = build_pyramid_arrays_device(c, 4, device=cuda, **kw)
    cmp = build_pyramid_arrays_device(c, 4, device=cuda, compact_conv=True,
                                      **kw)
    r = np.random.RandomState(4)
    w = torch.tensor(r.randn(729, 16, 24).astype(np.float32), device=cuda)
    for name, l_in, l_out in (("self_0", 0, 0), ("down_0", 0, 1),
                              ("up_0", 1, 0), ("self_2", 2, 2)):
        cap_in = dense[f"mask_{l_in}"].shape[0]
        rows = dense[f"mask_{l_out}"].shape[0]
        x = torch.tensor(r.randn(cap_in, 16).astype(np.float32),
                         device=cuda) * dense[f"mask_{l_in}"][:, None]
        kept = dense[name.replace("_", "_kept_")].long()
        ref = sparse_conv(append_sentinel(x), w[kept],
                          dense[name.replace("_", "_map_")])
        got = sparse_conv_compact(append_sentinel(x), w,
                                  cmp[name.replace("_", "_cmp_")], rows)
        np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                                   atol=1e-5 * ref.abs().max().item(),
                                   err_msg=name)


@pytest.mark.parametrize("dim", [3, 6])
def test_dgr_sparse_conv_backward_card_vs_cpu(cuda, dim):
    """sparse_conv's backward (the chunks gathered again; dx by an
    atomic index_add_ on the card) against the CPU's, within 1e-5 of
    each gradient's largest entry."""
    from gmf_tpu_torch.sparse.conv import append_sentinel, sparse_conv
    from gmf_tpu_torch.sparse.kernel_map import build_pyramid

    c = _dgr_coords(dim, 3000, 30 if dim == 3 else 6)
    pyr = build_pyramid(c, 4, conv1_kernel_size=3, granule=1024)
    r = np.random.RandomState(3)
    x = torch.tensor(r.randn(pyr.levels[0].cap, 32).astype(np.float32))
    nbr = torch.tensor(pyr.levels[0].self_map)
    w = torch.tensor(r.randn(nbr.shape[0], 32, 48).astype(np.float32))
    dy = torch.tensor(r.randn(pyr.levels[0].cap, 48).astype(np.float32))
    grads = []
    for dev in ("cpu", cuda):
        xx, ww = (t.to(dev).detach().requires_grad_() for t in (x, w))
        (sparse_conv(append_sentinel(xx), ww, nbr.to(dev))
         * dy.to(dev)).sum().backward()
        grads.append((xx.grad.cpu(), ww.grad.cpu()))
    for got, ref in zip(grads[1], grads[0]):
        np.testing.assert_allclose(got.numpy(), ref.numpy(),
                                   atol=1e-5 * ref.abs().max().item())


def test_dgr_trainer_pair_card_vs_cpu(cuda):
    """One WeightedProcrustesTrainer pair at gmf_tpu's test widths on the
    card (device maps) and the CPU (host maps), the CPU on the card's
    1-NN matches: the loss within 1e-5 relative, each gradient leaf
    within 1e-3 of its largest entry, the running statistics (train-mode
    MaskedBatchNorm) within 1e-4 of theirs."""
    from gmf_tpu_torch.data.dgr_loader import make_dgr_pair
    from gmf_tpu_torch.eval.test_dgr import tiny_nets
    from gmf_tpu_torch.train.dgr_trainer import WeightedProcrustesTrainer

    torch.manual_seed(0)
    states = [n.state_dict() for n in tiny_nets()]
    pair = make_dgr_pair(np.random.RandomState(11), n_points=600,
                         voxel_size=0.08, image_hw=(16, 16), surface=True)
    trainers = []
    for dev in (cuda, "cpu"):
        nets = tiny_nets()
        for net, state in zip(nets, states):
            net.load_state_dict(state)
        trainers.append(WeightedProcrustesTrainer(
            *nets, voxel_cap_granule=256, corr_cap_granule=256,
            device=dev))
    card, cpu = trainers
    assert card.device_maps and not cpu.device_maps
    matched, own = card.generate_inlier_input(pair), cpu.generate_inlier_input
    cpu.generate_inlier_input = lambda p: (matched[0], matched[1],
                                           *own(p)[2:])
    (g_card, m_card), (g_cpu, m_cpu) = (t.train_pair(pair) for t in trainers)
    assert abs(m_card["loss"] - m_cpu["loss"]) <= 1e-5 * abs(m_cpu["loss"])
    for a, b in zip(g_card, g_cpu):
        assert (a.cpu() - b).abs().max() <= 1e-3 * max(b.abs().max(), 1e-30)
    sd_card, sd_cpu = card.inlier.state_dict(), cpu.inlier.state_dict()
    for k, v in sd_cpu.items():
        if "running" in k:
            assert (sd_card[k].cpu() - v).abs().max() <= 1e-4 * max(
                v.abs().max(), 1e-30), k
