"""Forward variants of the compat-modulated attention, for the
attention-variant microbenchmark
(``gmf_tpu_torch.tools.bench_flash_variants``).

Counterpart of ``scripts/bench_flash_variants.py``'s kernel variants,
batched over pairs. Each computes

    out = softmax(compat * (q . k) / sqrt(D), masked keys -1e9) @ v

with a different compat term (sigma^2 = sigma_d^2, s and t the source and
target keypoints, ds/dt their distances from query i to key j):

    v0  squared distances by the norm identity |a|^2 + |b|^2 - 2 a.b
        (clamped at 0), then max(1 - (ds - dt)^2 / sigma^2, 0)
    v1  none: compat = 1, plain attention
    v2  per-coordinate differences, two sqrt (the streaming kernel's form)
    v3  per-coordinate differences, one sqrt:
        dd^2 = max(ds^2 + dt^2 - 2 sqrt(ds^2 dt^2), 0)
    v4  a bf16 compat cache, precomputed in v2's form
    v5  the same cache in f32
    v6  the norm identity with one sqrt

``flash_variant`` takes the variants that form compat in the kernel
(``IN_KERNEL``): it launches v0, v1, v3 and v6 as the four instances of
``csrc/compat_flash_variants.cu`` (counted under ``KERNELS``) and v2 as
the streaming kernel (``compat_flash_attention``). It is forward only. On
CPU tensors it runs ``flash_variant_plain``. v4 and v5 stream a cache:
``build_compat_cache(src, tgt, sigma_d, CACHE_DTYPES[variant])`` once,
then ``compat_flash_attention(q, k, v, None, None, compat=cache)``, each
of which runs its own plain version on CPU tensors.

Numerics:

- v0 and v6 form the dot and the norms in f32 over the three coordinates,
  each product and sum rounded on its own, in the kernel and in the plain
  version alike, so the two agree in every compat entry. On a TPU the
  script's distance dots (``dot_general`` at default precision over the
  coordinates padded to 128 zero columns) round their operands to bf16;
  in interpret mode on the CPU they are f32, which is what the port
  computes. The norm identity cancels where two points are close against
  their distance from the origin: its distances differ from v2's, a
  difference between variants, not a fault.
- The softmax is the port's core, not the script's: f32 probabilities,
  exp2 with log2(e) / sqrt(D) folded into q; under bf16 the scaled q and
  p are rounded to bf16 before their products (the script rounds q and
  k, applies the scale after the product, uses exp and rounds p). Kernel
  against plain version: 1e-5 in f32, 2 bf16 ulps of the largest |out|
  in bf16 (``chip_smoke.py``'s limits for every attention kernel).
- No padding: N may be any size and every key past N has weight 0. The
  script pads N to its tile and masks the padded keys, and reads [:N].
"""

from __future__ import annotations

import torch

from gmf_tpu_torch.ops import _build
from gmf_tpu_torch.ops.fused_attention import (
    _attend_plain, _check_keypts, _check_mask, _check_qkv, _compat_one_sqrt,
    _compat_two_sqrt, _pairwise_sqdist, _ptr, _qscale, _sigma_sq,
    _stream_compat_plain, compat_flash_attention)

VARIANTS = ("v0", "v1", "v2", "v3", "v4", "v5", "v6")
# the variants ``flash_variant`` takes: compat formed in the kernel (v1:
# none)
IN_KERNEL = ("v0", "v1", "v2", "v3", "v6")
# variants with an instance of their own: the C entry point's number
_VARIANT_IDS = {"v0": 0, "v1": 1, "v3": 3, "v6": 6}
KERNELS = {v: f"compat_flash_variant_{v}" for v in _VARIANT_IDS}
# query rows and keys per block of csrc/compat_flash_core.cuh (BQ, BK)
TILE = (64, 32)
# v4 and v5: the cache type of the standalone cache they stream
CACHE_DTYPES = {"v4": torch.bfloat16, "v5": torch.float32}
# f32 elements of one [B, rows, N] temporary of the plain version
PLAIN_CHUNK = 1 << 26


def _check_variant(variant):
    if variant in CACHE_DTYPES:
        raise ValueError(
            f"{variant} streams a cache: build_compat_cache(..., "
            f"{CACHE_DTYPES[variant]}), then compat_flash_attention(q, k, "
            "v, None, None, compat=cache)")
    if variant not in IN_KERNEL:
        raise ValueError(f"variant {variant!r} not in {IN_KERNEL}")


def _norm_id_sqdist(a, b):
    """[B, R, 3], [B, N, 3] -> [B, R, N]: |a|^2 + |b|^2 - 2 a.b clamped at
    0, norms and dot summed as (x + y) + z, as the kernels do."""
    def norm(x):
        return (x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1]) + (
            x[..., 2] * x[..., 2])

    na, nb = norm(a), norm(b)
    dot = None
    for c in range(3):
        term = a[:, :, None, c] * b[:, None, :, c]
        dot = term if dot is None else dot + term
    return torch.clamp((na[:, :, None] + nb[:, None, :]) - 2.0 * dot,
                       min=0.0)


def _variant_compat_plain(src_keypts, tgt_keypts, variant, sigma_d=0.10,
                          rows=slice(None)):
    """Dense f32 compat [B, R, N] of query ``rows`` against every key for
    v0, v2, v3 and v6 (v1: the scalar 1.0), as the kernels compute it."""
    if variant == "v1":
        return 1.0
    if variant == "v2":
        return _stream_compat_plain(src_keypts, tgt_keypts, sigma_d, rows)
    src, tgt = src_keypts.float(), tgt_keypts.float()
    sqdist = _pairwise_sqdist if variant == "v3" else _norm_id_sqdist
    ds2 = sqdist(src[:, rows], src)
    dt2 = sqdist(tgt[:, rows], tgt)
    form = _compat_two_sqrt if variant == "v0" else _compat_one_sqrt
    return form(ds2, dt2, _sigma_sq(sigma_d, src.device))


def flash_variant_plain(q, k, v, src_keypts, tgt_keypts, mask=None, *,
                        variant, sigma_d: float = 0.10):
    """Plain version of ``flash_variant``: the same compat and softmax in
    dense f32 PyTorch, in slices of query rows so that a [B, rows, N]
    temporary holds at most ``PLAIN_CHUNK`` entries (8 x 5000 pairs fit
    on the card). Returns [B, N, D] in q's dtype."""
    B, N, _ = q.shape
    _check_variant(variant)
    step = max(1, PLAIN_CHUNK // max(1, B * N))
    outs = []
    for r0 in range(0, N, step):
        rows = slice(r0, r0 + step)
        compat = _variant_compat_plain(src_keypts, tgt_keypts, variant,
                                       sigma_d, rows)
        outs.append(_attend_plain(q[:, rows], k, v, compat, mask)[0])
    return torch.cat(outs, dim=1)


def flash_variant(q, k, v, src_keypts, tgt_keypts, mask=None, *, variant,
                  sigma_d: float = 0.10):
    """Compat-modulated attention with compat formed in the kernel in one
    of the microbenchmark's forms ``variant`` (``IN_KERNEL``, see the
    module docstring; v4 and v5 raise ValueError).

    q, k, v: [B, N, D] f32 or bf16 (D in 32, 128 on CUDA); keypoints
    [B, N, 3] (v1 ignores them); mask: optional [B, N] key validity.
    Returns [B, N, D] in q's dtype."""
    _check_variant(variant)
    if q.device.type == "cpu":
        return flash_variant_plain(q, k, v, src_keypts, tgt_keypts, mask,
                                   variant=variant, sigma_d=sigma_d)
    if variant == "v2":
        return compat_flash_attention(q, k, v, src_keypts, tgt_keypts, mask,
                                      sigma_d)
    name = KERNELS[variant]
    q, k, v = _check_qkv(name, q, k, v)
    B, N, D = q.shape
    src = tgt = None
    if variant != "v1":
        src, tgt = _check_keypts(name, src_keypts, tgt_keypts, B, N)
    m = _check_mask(name, mask, B, N, q.device)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out  # nothing to launch
    code = _build.load().gmf_compat_flash_variant(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(src), _ptr(tgt),
        m.data_ptr(), out.data_ptr(), B, N, D, _VARIANT_IDS[variant],
        int(q.dtype == torch.bfloat16), float(sigma_d) ** 2,
        _qscale(D), _build.stream_of(q))
    _build.check(code, name)
    return out
