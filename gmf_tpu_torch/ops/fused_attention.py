"""Compat-modulated attention: CUDA kernels and their plain versions.

Counterpart of ``gmf_tpu/ops/fused_attention.py`` (forward and its
``custom_vjp`` backward), batched over pairs:

    compat[i,j] = max(0, 1 - (|s_i - s_j| - |t_i - t_j|)^2 / sigma^2)
    out         = softmax(compat * (q . k) / sqrt(D), masked keys -1e9) @ v

Each function launches its kernel on CUDA tensors and uses its plain
version (``*_plain``) only for CPU tensors:

- ``compat_flash_attention``: streaming mode rebuilds compat from the
  keypoints in every call (``csrc/compat_flash_attention.cu``); with
  ``compat=cache`` it streams a precomputed cache instead
  (``csrc/compat_flash_attention_cached.cu``). When q, k or v needs a
  gradient it runs as a ``torch.autograd.Function`` whose forward also
  writes the rows' base-2 log-sum-exp and whose backward is
  ``compat_flash_attention_bwd``: the dK/dV and the dQ kernels
  (``csrc/compat_flash_attention_bwd.cu``,
  ``csrc/compat_flash_attention_cached_bwd.cu``). Gradients go to q, k
  and v only; keypoints, mask and cache are data.
- ``build_compat_cache``: the cache on its own, f32, bf16 or int8
  (``csrc/build_compat_cache.cu``).
- ``compat_flash_attention_build``: the first layer's attention, which
  also emits the int8 cache for the layers after it
  (``csrc/compat_flash_attention_build.cu``).

The int8 cache holds ``round(254 c - 127)`` and is read as
``code / 254 + 0.5``; its codes come from the one-sqrt form
``ds2 + dt2 - 2 sqrt(ds2 dt2)``, the f32 and bf16 caches from the two-sqrt
difference, as in the reference.

Numerics: bf16 q, k, v take their products on the tensor cores in bf16,
rounding q * scale * log2(e) and p to bf16 as the TPU kernels do. f32
q, k, v take them on the tensor cores too, each operand split into three
bf16 terms and each product into six term products
(``csrc/compat_flash_core.cuh``): some 2^-24 of the operands' scale, as
f32 itself, so the f32 kernels stay within 1e-5 of their plain versions
but are not equal to them in every bit. The int8 cache is equal in every
byte across its three producers, and the build+attend output equals the
cached kernel's on that cache in every bit, in f32 and bf16.

Cache layout (the port's own): ``[B, N, ld]``, exactly N valid entries
per row and a row stride ``ld = cache_row_stride(N, dtype)`` that keeps
every row 16-byte aligned; entries past column N are zero and are never
read as keys.
"""

from __future__ import annotations

import math

import torch

from gmf_tpu_torch.ops import _build

NEG_INF = -1e9
_LOG2E = 1.4426950408889634
KERNEL = "compat_flash_attention"
KERNEL_CACHED = "compat_flash_attention_cached"
KERNEL_BUILD = "compat_flash_attention_build"
KERNEL_CACHE = "build_compat_cache"
KERNEL_BWD_DKV = "compat_flash_attention_bwd_dkv"
KERNEL_BWD_DQ = "compat_flash_attention_bwd_dq"
KERNEL_CACHED_BWD_DKV = "compat_flash_attention_cached_bwd_dkv"
KERNEL_CACHED_BWD_DQ = "compat_flash_attention_cached_bwd_dq"
# lse of masked query rows in the backward: p = exp2(s - 1e9) is exactly 0
LSE_PAD = 1e9

_I8_SCALE = 254.0
_I8_BIAS = 127.0
# cache element types, numbered as the C entry points number them
_CACHE_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def cache_row_stride(N: int, dtype: torch.dtype) -> int:
    """Row stride ``ld`` (in elements) of a compat cache for N
    correspondences: N rounded up so that a row spans a multiple of 16
    bytes. The cache kernels and their plain versions all take it from
    here."""
    if dtype not in _CACHE_TYPES:
        raise TypeError(f"compat cache dtype {dtype} not in f32/bf16/int8")
    per16 = 16 // torch.empty((), dtype=dtype).element_size()
    return -(-N // per16) * per16


def _pairwise_sqdist(x, y=None):
    """[B, R, 3], [B, N, 3] (default: x) -> [B, R, N] squared Euclidean
    distances, from per-coordinate differences (no norm-identity
    cancellation), summed as (x^2 + y^2) + z^2."""
    y = x if y is None else y
    d2 = None
    for c in range(3):
        diff = x[:, :, None, c] - y[:, None, :, c]
        d2 = diff * diff if d2 is None else d2 + diff * diff
    return d2


def _sqrt(x):
    """Correctly rounded f32 square root, as CUDA's ``sqrtf`` and the
    reference's are. PyTorch's vectorised CPU sqrt can land one ulp low,
    which the one-sqrt int8 form amplifies into other codes; through f64
    the result is exact (for a square root the second rounding cannot
    change it)."""
    if x.device.type == "cpu":
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


def _pairwise_dist(x, y=None):
    return _sqrt(_pairwise_sqdist(x, y))


def _compat_two_sqrt(ds2, dt2, sigma_sq):
    """max(1 - (sqrt(ds2) - sqrt(dt2))^2 / sigma^2, 0), one rounding per
    operation as in the kernels; ``sigma_sq`` is a tensor (see
    ``_sigma_sq``)."""
    dd = _sqrt(ds2) - _sqrt(dt2)
    return torch.clamp(1.0 - dd * dd / sigma_sq, min=0.0)


def _compat_one_sqrt(ds2, dt2, sigma_sq):
    """The one-sqrt form of ``_compat_two_sqrt``:
    (sqrt(a) - sqrt(b))^2 = max(a + b - 2 sqrt(ab), 0)."""
    dd2 = torch.clamp(ds2 + dt2 - 2.0 * _sqrt(ds2 * dt2), min=0.0)
    return torch.clamp(1.0 - dd2 / sigma_sq, min=0.0)


def _sigma_sq(sigma_d, device):
    """sigma_d^2 as an f32 tensor: PyTorch turns a division by a Python
    scalar into a multiplication by its reciprocal on CUDA, one rounding
    more than the kernels' division."""
    return torch.tensor(float(sigma_d) ** 2, dtype=torch.float32,
                        device=device)


def _qscale(D: int) -> float:
    """scale * log2(e): folds the 1/sqrt(D) scale and the base-2 softmax
    into q."""
    return (1.0 / math.sqrt(D)) * _LOG2E


def _rounder(dtype):
    """Rounding to the kernels' product type: bf16 for bf16 inputs, none
    for f32."""
    if dtype == torch.bfloat16:
        return lambda x: x.to(torch.bfloat16).float()
    return lambda x: x


def _logits_plain(q, k, compat, mask):
    """Base-2 logits compat * (q * scale * log2(e)) . k, masked keys
    -1e9, in f32; under bf16 the scaled q is rounded first, as in the
    kernels. q may hold a slice of the query rows."""
    qs = _rounder(q.dtype)(q.float() * _qscale(q.shape[-1]))
    logits = compat * torch.matmul(qs, k.float().transpose(-1, -2))
    if mask is not None:
        logits = torch.where(mask[:, None, :] > 0, logits,
                             torch.full_like(logits, NEG_INF))
    return logits


def _attend_plain(q, k, v, compat, mask):
    """softmax(compat * q.k, masked) @ v with a dense f32 compat
    [B, N, N], and the rows' base-2 log-sum-exp [B, N] f32.

    The softmax is base 2 with scale * log2(e) folded into q, as in the
    kernels. Under bf16 the scaled q and the probabilities are rounded to
    bf16 before their products, as the kernels do, so the two differ only
    by f32 summation order and the kernels' running max.
    """
    logits = _logits_plain(q, k, compat, mask)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp2(logits - m)
    denom = p.sum(dim=-1, keepdim=True)
    lse = (m + torch.log2(torch.clamp(denom, min=1e-30)))[..., 0]
    out = torch.matmul(_rounder(q.dtype)(p), v.float()) / denom
    return out.to(q.dtype), lse


def _attend_bwd_plain(q, k, v, do, out, lse, compat, mask):
    """The gradient of ``_attend_plain`` with respect to q, k and v as the
    backward kernels form it: p recomputed from the forward's lse (1e9 on
    masked query rows, so their p and every gradient through them is 0),
    dlogits = p (dp - delta) compat scale, and under bf16 the kernels'
    roundings before each product."""
    D = q.shape[-1]
    rnd = _rounder(q.dtype)
    if mask is not None:
        lse = torch.where(mask > 0, lse, torch.full_like(lse, LSE_PAD))
    p = torch.exp2(_logits_plain(q, k, compat, mask) - lse[..., None])
    do32 = do.float()
    dp = torch.matmul(do32, v.float().transpose(-1, -2))
    delta = (do32 * out.float()).sum(-1)
    ds = p * (dp - delta[..., None]) * compat * (1.0 / math.sqrt(D))
    ds = rnd(ds)
    dv = torch.matmul(rnd(p).transpose(-1, -2), do32)
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    dq = torch.matmul(ds, k.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _stream_compat_plain(src_keypts, tgt_keypts, sigma_d,
                         rows=slice(None)):
    """Dense [B, N, N] f32 compat of the streaming mode, or [B, R, N] of
    the query ``rows`` against every key."""
    src, tgt = src_keypts.float(), tgt_keypts.float()
    compat = (_pairwise_dist(src[:, rows], src)
              - _pairwise_dist(tgt[:, rows], tgt))
    return torch.clamp(1.0 - compat * compat / sigma_d ** 2, min=0.0)


def compat_attention_plain(q, k, v, src_keypts, tgt_keypts, mask=None,
                           sigma_d: float = 0.10, return_lse: bool = False):
    """Dense version of the streaming mode: materialises the [B, N, N]
    compat and logits in f32. q, k, v [B, N, D]; keypoints [B, N, 3];
    mask [B, N] -> [B, N, D], and with ``return_lse`` also the rows'
    base-2 log-sum-exp [B, N] f32, the backward's input."""
    out, lse = _attend_plain(
        q, k, v, _stream_compat_plain(src_keypts, tgt_keypts, sigma_d), mask)
    return (out, lse) if return_lse else out


def _load_compat(cache, N: int):
    """The valid [B, N, N] part of a cache as f32; int8 codes are read as
    ``code * (1 / 254) + 0.5``."""
    c = cache[:, :, :N]
    if cache.dtype == torch.int8:
        return c.float() * (1.0 / _I8_SCALE) + 0.5
    return c.float()


def compat_attention_cached_plain(q, k, v, compat, mask=None,
                                  return_lse: bool = False):
    """Dense version of the cached mode; ``compat`` is a [B, N, ld]
    cache. ``return_lse`` as in ``compat_attention_plain``."""
    out, lse = _attend_plain(q, k, v, _load_compat(compat, q.shape[1]),
                             mask)
    return (out, lse) if return_lse else out


def compat_attention_bwd_plain(q, k, v, do, out, lse, mask=None,
                               src_keypts=None, tgt_keypts=None,
                               sigma_d: float = 0.10, compat=None):
    """Plain version of ``compat_flash_attention_bwd``: ``(dq, dk, dv)``
    of the streaming mode (keypoints) or of the cached mode (``compat``, a
    [B, N, ld] cache), from the forward's ``out`` and ``lse``.

    This is the gradient the kernels compute, not autograd of the plain
    forward: the two agree on valid query rows, and on masked query rows
    this one is 0 by construction (their p is 0), as in the reference."""
    if compat is not None:
        c = _load_compat(compat, q.shape[1])
    else:
        c = _stream_compat_plain(src_keypts, tgt_keypts, sigma_d)
    return _attend_bwd_plain(q, k, v, do, out, lse, c, mask)


def build_compat_cache_plain(src_keypts, tgt_keypts, sigma_d: float = 0.10,
                             dtype: torch.dtype = torch.bfloat16):
    """Plain version of ``build_compat_cache``: the same operations in
    the same order, one rounding each, on dense [B, N, N] tensors."""
    B, N, _ = src_keypts.shape
    ld = cache_row_stride(N, dtype)
    sigma_sq = _sigma_sq(sigma_d, src_keypts.device)
    ds2 = _pairwise_sqdist(src_keypts.float())
    dt2 = _pairwise_sqdist(tgt_keypts.float())
    if dtype == torch.int8:
        c = _compat_one_sqrt(ds2, dt2, sigma_sq)
        vals = torch.round(c * _I8_SCALE - _I8_BIAS).to(torch.int8)
    else:
        vals = _compat_two_sqrt(ds2, dt2, sigma_sq).to(dtype)
    cache = torch.zeros(B, N, ld, dtype=dtype, device=src_keypts.device)
    cache[:, :, :N] = vals
    return cache


def compat_flash_attention_build_plain(q, k, v, src_keypts, tgt_keypts,
                                       mask=None, sigma_d: float = 0.10):
    """Plain version of ``compat_flash_attention_build``: the int8 cache,
    and the attention on that cache."""
    cache = build_compat_cache_plain(src_keypts, tgt_keypts, sigma_d,
                                     torch.int8)
    return compat_attention_cached_plain(q, k, v, cache, mask), cache


def _check_qkv(name, q, k, v, forward: bool = False):
    """Device, type and shape checks shared by the attention wrappers;
    returns contiguous q, k, v. ``forward``: the caller launches a forward
    kernel, which needs q, k and v 16-byte aligned (bf16: refused
    otherwise; f32: copied)."""
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: q/k/v must be f32 or bf16, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: q, k and v must share a dtype")
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{name}: q/k/v must share a shape [B, N, D]")
    if q.shape[-1] not in (32, 128):
        raise ValueError(
            f"{name}: head width {q.shape[-1]} not built (32/128)")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    # the forward kernels move q, k and v in 16-byte chunks: a bf16 view
    # that starts off a boundary is refused, an f32 one copied to fresh
    # storage (as bwd_inputs copies the backward's)
    if forward and any(t.data_ptr() % 16 for t in (q, k, v)):
        if q.dtype == torch.bfloat16:
            raise ValueError(f"{name}: bf16 q/k/v must start 16-byte "
                             "aligned")
        q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone()
                   for t in (q, k, v))
    return q, k, v


def _check_keypts(name, src_keypts, tgt_keypts, B, N):
    for kp in (src_keypts, tgt_keypts):
        if kp.device.type != "cuda":
            raise ValueError(f"{name}: unsupported device {kp.device}")
    if src_keypts.shape != (B, N, 3) or tgt_keypts.shape != (B, N, 3):
        raise ValueError(f"{name}: keypoints must be [B, N, 3]")
    return src_keypts.float().contiguous(), tgt_keypts.float().contiguous()


def _check_mask(name, mask, B, N, device):
    m = (torch.ones(B, N, device=device) if mask is None
         else mask.float().contiguous())
    if m.shape != (B, N):
        raise ValueError(f"{name}: mask must be [B, N]")
    return m


def _check_cache(name, compat, B, N):
    if compat.dtype not in _CACHE_TYPES:
        raise TypeError(f"{name}: cache dtype {compat.dtype} not in "
                        "f32/bf16/int8")
    ld = cache_row_stride(N, compat.dtype)
    if compat.shape != (B, N, ld) or not compat.is_contiguous():
        raise ValueError(
            f"{name}: compat cache of shape {tuple(compat.shape)} does not "
            f"match the layout {(B, N, ld)} for N={N} and {compat.dtype}; "
            "build it with build_compat_cache")
    return ld


def compat_flash_attention(q, k, v, src_keypts, tgt_keypts, mask=None,
                           sigma_d: float = 0.10, compat=None):
    """Compat-modulated single-head attention over a batch of pairs.

    q, k, v: [B, N, D] f32 or bf16 (D in 32, 128 on CUDA);
    src_keypts, tgt_keypts: [B, N, 3]; mask: optional [B, N] key validity.
    compat: optional [B, N, ld] cache from ``build_compat_cache`` or
    ``compat_flash_attention_build``; the keypoints may then be None.
    Returns [B, N, D] in q's dtype. Differentiable with respect to q, k
    and v (``compat_flash_attention_bwd``); masked query rows get no
    gradient, as in the reference.
    """
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        if compat is not None:
            return _CachedAttention.apply(q, k, v, compat, mask)
        return _StreamingAttention.apply(q, k, v, src_keypts, tgt_keypts,
                                         mask, sigma_d)
    if compat is not None:
        return _cached_forward(q, k, v, compat, mask, False)[0]
    return _streaming_forward(q, k, v, src_keypts, tgt_keypts, mask,
                              sigma_d, False)[0]


def _lse_out(with_lse: bool, q):
    """The [B, N] f32 lse output, or None (the kernel then writes none)."""
    if not with_lse:
        return None
    return torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)


def _ptr(t):
    return 0 if t is None else t.data_ptr()


def _streaming_forward(q, k, v, src_keypts, tgt_keypts, mask, sigma_d,
                       with_lse: bool):
    """(out, lse or None) of the streaming mode."""
    if q.device.type == "cpu":
        out, lse = compat_attention_plain(q, k, v, src_keypts, tgt_keypts,
                                          mask, sigma_d, return_lse=True)
        return out, (lse if with_lse else None)
    q, k, v = _check_qkv(KERNEL, q, k, v, forward=True)
    B, N, D = q.shape
    src, tgt = _check_keypts(KERNEL, src_keypts, tgt_keypts, B, N)
    m = _check_mask(KERNEL, mask, B, N, q.device)
    out = torch.empty_like(q)
    lse = _lse_out(with_lse, q)
    if out.numel() == 0:
        return out, lse  # nothing to launch
    code = _build.load().gmf_compat_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), src.data_ptr(),
        tgt.data_ptr(), m.data_ptr(), out.data_ptr(), _ptr(lse), B, N, D,
        int(q.dtype == torch.bfloat16), float(sigma_d) ** 2, _qscale(D),
        _build.stream_of(q))
    _build.check(code, KERNEL)
    return out, lse


def _cached_forward(q, k, v, compat, mask, with_lse: bool):
    """(out, lse or None) of the cached mode."""
    if q.device.type == "cpu" and compat.device.type == "cpu":
        _check_cache(KERNEL_CACHED, compat, q.shape[0], q.shape[1])
        out, lse = compat_attention_cached_plain(q, k, v, compat, mask,
                                                 return_lse=True)
        return out, (lse if with_lse else None)
    q, k, v = _check_qkv(KERNEL_CACHED, q, k, v, forward=True)
    B, N, D = q.shape
    if compat.device != q.device:
        raise ValueError(f"{KERNEL_CACHED}: cache on {compat.device}, "
                         f"q on {q.device}")
    ld = _check_cache(KERNEL_CACHED, compat, B, N)
    m = _check_mask(KERNEL_CACHED, mask, B, N, q.device)
    out = torch.empty_like(q)
    lse = _lse_out(with_lse, q)
    if out.numel() == 0:
        return out, lse
    code = _build.load().gmf_compat_flash_attention_cached(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), compat.data_ptr(),
        m.data_ptr(), out.data_ptr(), _ptr(lse), B, N, D, ld,
        int(q.dtype == torch.bfloat16), _CACHE_TYPES[compat.dtype],
        _qscale(D), _build.stream_of(q))
    _build.check(code, KERNEL_CACHED)
    return out, lse


class _StreamingAttention(torch.autograd.Function):
    """Streaming mode with its flash backward; the counterpart of the
    reference's ``_flash`` custom_vjp."""

    @staticmethod
    def forward(ctx, q, k, v, src_keypts, tgt_keypts, mask, sigma_d):
        out, lse = _streaming_forward(q, k, v, src_keypts, tgt_keypts, mask,
                                      sigma_d, True)
        ctx.save_for_backward(q, k, v, out, lse, src_keypts, tgt_keypts,
                              mask)
        ctx.sigma_d = sigma_d
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, src, tgt, mask = ctx.saved_tensors
        dq, dk, dv = compat_flash_attention_bwd(
            q, k, v, dout, out, lse, mask, src, tgt, ctx.sigma_d)
        return dq, dk, dv, None, None, None, None


class _CachedAttention(torch.autograd.Function):
    """Cached mode with its flash backward; the counterpart of the
    reference's ``_flash_cached`` custom_vjp. The cache is data."""

    @staticmethod
    def forward(ctx, q, k, v, compat, mask):
        out, lse = _cached_forward(q, k, v, compat, mask, True)
        ctx.save_for_backward(q, k, v, out, lse, compat, mask)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, compat, mask = ctx.saved_tensors
        dq, dk, dv = compat_flash_attention_bwd(q, k, v, dout, out, lse,
                                                mask, compat=compat)
        return dq, dk, dv, None, None


def compat_flash_attention_bwd(q, k, v, do, out, lse, mask=None,
                               src_keypts=None, tgt_keypts=None,
                               sigma_d: float = 0.10, compat=None):
    """``(dq, dk, dv)`` of ``compat_flash_attention`` from the forward's
    ``out`` and base-2 ``lse`` [B, N] and the output gradient ``do``:
    streaming mode from the keypoints, cached mode from ``compat``. On
    CUDA tensors it launches the dK/dV kernel, then the dQ kernel; on CPU
    tensors it runs ``compat_attention_bwd_plain``."""
    if q.device.type == "cpu":
        return compat_attention_bwd_plain(q, k, v, do, out, lse, mask,
                                          src_keypts, tgt_keypts, sigma_d,
                                          compat)
    inp = bwd_inputs(q, k, v, do, out, lse, mask)
    dk, dv = bwd_dkv(inp, src_keypts, tgt_keypts, sigma_d, compat)
    return bwd_dq(inp, src_keypts, tgt_keypts, sigma_d, compat), dk, dv


def bwd_inputs(q, k, v, do, out, lse, mask):
    """Checked CUDA inputs of the backward kernels: q, k, v, do contiguous
    of one type and 16-byte aligned (the cached kernels copy 16-byte
    chunks; a view that starts off a boundary is copied to fresh storage),
    the mask as f32, lse with ``LSE_PAD`` on masked query rows, and delta =
    rowsum(do * out) in f32, formed outside the kernels as the reference
    does."""
    q, k, v = _check_qkv(KERNEL_BWD_DKV, q, k, v)
    B, N, _ = q.shape
    do = do.to(q.dtype).contiguous()
    q, k, v, do = (t if t.data_ptr() % 16 == 0 else t.clone()
                   for t in (q, k, v, do))
    if do.shape != q.shape or out.shape != q.shape:
        raise ValueError(f"{KERNEL_BWD_DKV}: do and out must be [B, N, D]")
    if lse.shape != (B, N):
        raise ValueError(f"{KERNEL_BWD_DKV}: lse must be [B, N]")
    m = _check_mask(KERNEL_BWD_DKV, mask, B, N, q.device)
    lse = torch.where(m > 0, lse.float(),
                      torch.full_like(m, LSE_PAD)).contiguous()
    delta = (do.float() * out.float()).sum(-1).contiguous()
    return dict(q=q, k=k, v=v, do=do, lse=lse, delta=delta, mask=m)


def _bwd_common(inp):
    q = inp["q"]
    B, N, D = q.shape
    head = [q.data_ptr(), inp["k"].data_ptr(), inp["v"].data_ptr(),
            inp["do"].data_ptr(), inp["lse"].data_ptr(),
            inp["delta"].data_ptr()]
    return q, B, N, D, head


def bwd_dkv(inp, src_keypts=None, tgt_keypts=None, sigma_d: float = 0.10,
            compat=None):
    """Launch the dK/dV kernel on ``bwd_inputs``: ``(dk, dv)``."""
    q, B, N, D, head = _bwd_common(inp)
    dk, dv = torch.empty_like(q), torch.empty_like(q)
    if q.numel() == 0:
        return dk, dv
    bf16 = int(q.dtype == torch.bfloat16)
    lib = _build.load()
    if compat is None:
        src, tgt = _check_keypts(KERNEL_BWD_DKV, src_keypts, tgt_keypts, B,
                                 N)
        code = lib.gmf_compat_flash_attention_bwd_dkv(
            *head, src.data_ptr(), tgt.data_ptr(), inp["mask"].data_ptr(),
            dk.data_ptr(), dv.data_ptr(), B, N, D, bf16,
            float(sigma_d) ** 2, _qscale(D), 1.0 / math.sqrt(D),
            _build.stream_of(q))
        _build.check(code, KERNEL_BWD_DKV)
        return dk, dv
    ld = _check_cache(KERNEL_CACHED_BWD_DKV, compat, B, N)
    code = lib.gmf_compat_flash_attention_cached_bwd_dkv(
        *head, compat.data_ptr(), inp["mask"].data_ptr(), dk.data_ptr(),
        dv.data_ptr(), B, N, D, ld, bf16, _CACHE_TYPES[compat.dtype],
        _qscale(D), 1.0 / math.sqrt(D), _build.stream_of(q))
    _build.check(code, KERNEL_CACHED_BWD_DKV)
    return dk, dv


def bwd_dq(inp, src_keypts=None, tgt_keypts=None, sigma_d: float = 0.10,
           compat=None):
    """Launch the dQ kernel on ``bwd_inputs``: ``dq``."""
    q, B, N, D, head = _bwd_common(inp)
    dq = torch.empty_like(q)
    if q.numel() == 0:
        return dq
    bf16 = int(q.dtype == torch.bfloat16)
    lib = _build.load()
    if compat is None:
        src, tgt = _check_keypts(KERNEL_BWD_DQ, src_keypts, tgt_keypts, B, N)
        code = lib.gmf_compat_flash_attention_bwd_dq(
            *head, src.data_ptr(), tgt.data_ptr(), inp["mask"].data_ptr(),
            dq.data_ptr(), B, N, D, bf16, float(sigma_d) ** 2, _qscale(D),
            1.0 / math.sqrt(D), _build.stream_of(q))
        _build.check(code, KERNEL_BWD_DQ)
        return dq
    ld = _check_cache(KERNEL_CACHED_BWD_DQ, compat, B, N)
    code = lib.gmf_compat_flash_attention_cached_bwd_dq(
        *head, compat.data_ptr(), inp["mask"].data_ptr(), dq.data_ptr(), B,
        N, D, ld, bf16, _CACHE_TYPES[compat.dtype], _qscale(D),
        1.0 / math.sqrt(D), _build.stream_of(q))
    _build.check(code, KERNEL_CACHED_BWD_DQ)
    return dq


def build_compat_cache(src_keypts, tgt_keypts, sigma_d: float = 0.10,
                       dtype: torch.dtype = torch.bfloat16):
    """The spatial-consistency matrix of every pair, computed once:
    keypoints [B, N, 3] -> [B, N, ld] cache of ``dtype`` (f32, bf16 or
    int8), ``ld = cache_row_stride(N, dtype)``, pad columns zero. Rows are
    queries, columns keys. Masked correspondences have entries too; the
    attention's mask excludes them."""
    ld = cache_row_stride(src_keypts.shape[1], dtype)
    if src_keypts.device.type == "cpu" and tgt_keypts.device.type == "cpu":
        return build_compat_cache_plain(src_keypts, tgt_keypts, sigma_d,
                                        dtype)
    if src_keypts.dim() != 3:
        raise ValueError(f"{KERNEL_CACHE}: keypoints must be [B, N, 3]")
    B, N, _ = src_keypts.shape
    src, tgt = _check_keypts(KERNEL_CACHE, src_keypts, tgt_keypts, B, N)
    cache = torch.empty(B, N, ld, dtype=dtype, device=src.device)
    if cache.numel() == 0:
        return cache
    code = _build.load().gmf_build_compat_cache(
        src.data_ptr(), tgt.data_ptr(), cache.data_ptr(), B, N, ld,
        _CACHE_TYPES[dtype], float(sigma_d) ** 2, _build.stream_of(src))
    _build.check(code, KERNEL_CACHE)
    return cache


def compat_flash_attention_build(q, k, v, src_keypts, tgt_keypts, mask=None,
                                 sigma_d: float = 0.10):
    """First-layer attention that also emits the int8 compat cache for
    the layers after it (forward only).

    Returns ``(out [B, N, D], cache [B, N, ld] int8)``: the cache equals
    ``build_compat_cache(..., dtype=torch.int8)`` in every byte and out
    equals ``compat_flash_attention(..., compat=cache)``, since the
    attention runs on the dequantized codes.
    """
    if q.device.type == "cpu":
        return compat_flash_attention_build_plain(q, k, v, src_keypts,
                                                  tgt_keypts, mask, sigma_d)
    q, k, v = _check_qkv(KERNEL_BUILD, q, k, v, forward=True)
    B, N, D = q.shape
    src, tgt = _check_keypts(KERNEL_BUILD, src_keypts, tgt_keypts, B, N)
    m = _check_mask(KERNEL_BUILD, mask, B, N, q.device)
    ld = cache_row_stride(N, torch.int8)
    out = torch.empty_like(q)
    cache = torch.empty(B, N, ld, dtype=torch.int8, device=q.device)
    if out.numel() == 0:
        return out, cache
    code = _build.load().gmf_compat_flash_attention_build(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), src.data_ptr(),
        tgt.data_ptr(), m.data_ptr(), out.data_ptr(), cache.data_ptr(), B, N,
        D, ld, int(q.dtype == torch.bfloat16), float(sigma_d) ** 2,
        _qscale(D), _build.stream_of(q))
    _build.check(code, KERNEL_BUILD)
    return out, cache
