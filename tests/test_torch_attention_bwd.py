"""The port's attention backward and log-sum-exp vs gmf_tpu's Pallas
custom_vjp, on the CPU.

The port's ``compat_flash_attention`` runs as a torch.autograd.Function
whose forward and backward take their plain versions on CPU tensors;
gmf_tpu's runs its Pallas kernels in interpret mode (f32 products), as its
own tests do. Cached modes give both sides the same cache: gmf_tpu's
builder fills the padded [Np, Np] array, and its valid [N, N] part is
copied into the port's [B, N, ld] layout, so the int8 codes that the two
builders round differently (tests/test_torch_ops.py) cannot enter the
comparison. The CUDA kernels are held against these plain versions on the
card by tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gmf_tpu.ops import fused_attention as jattn
from gmf_tpu_torch.ops.fused_attention import (
    _load_compat, _logits_plain, _stream_compat_plain, build_compat_cache,
    cache_row_stride, compat_attention_bwd_plain,
    compat_attention_cached_plain, compat_attention_plain,
    compat_flash_attention)

torch.set_num_threads(1)

_JAX_DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
               torch.int8: jnp.int8}


def _problem(seed, B=2, N=150, D=32, masked=True):
    """N=150 is no multiple of the 64/128 blocks; pair 0 drops its last
    30 correspondences, pair 1 a random fifth."""
    rng = np.random.RandomState(seed)
    q, k, v, do = (rng.randn(B, N, D).astype(np.float32) for _ in range(4))
    src = (rng.rand(B, N, 3) * 2.5).astype(np.float32)
    tgt = (src + 0.02 * rng.randn(B, N, 3)).astype(np.float32)
    tgt[:, ::3] = (rng.rand(B, (N + 2) // 3, 3) * 2.5).astype(np.float32)
    mask = np.ones((B, N), np.float32)
    if masked:
        mask[0, N - 30:] = 0.0
        mask[1, rng.rand(N) < 0.2] = 0.0
    return q, k, v, do, src, tgt, mask


def _port_cache(jax_caches, N, dtype):
    """gmf_tpu's per-pair [Np, Np] caches -> the port's [B, N, ld]."""
    ld = cache_row_stride(N, dtype)
    cache = torch.zeros(len(jax_caches), N, ld, dtype=dtype)
    for b, c in enumerate(jax_caches):
        valid = np.asarray(c[:N, :N].astype(jnp.float32))
        cache[b, :, :N] = torch.tensor(valid).to(dtype)
    return cache


def _jax_vjp(q, k, v, do, src, tgt, mask, cache=None):
    """Per pair: (out, dq, dk, dv) of gmf_tpu's attention, interpret
    mode."""
    res = []
    for b in range(q.shape[0]):
        def f(qq, kk, vv):
            if cache is None:
                return jattn.compat_flash_attention(
                    qq, kk, vv, jnp.asarray(src[b]), jnp.asarray(tgt[b]),
                    mask=jnp.asarray(mask[b]), sigma_d=0.10, interpret=True)
            return jattn.compat_flash_attention(
                qq, kk, vv, None, None, mask=jnp.asarray(mask[b]),
                compat=cache[b], interpret=True)
        out, vjp = jax.vjp(f, jnp.asarray(q[b]), jnp.asarray(k[b]),
                           jnp.asarray(v[b]))
        res.append((np.asarray(out),) + tuple(map(np.asarray,
                                                  vjp(jnp.asarray(do[b])))))
    return [np.stack(x) for x in zip(*res)]


def _port_grads(q, k, v, do, src, tgt, mask, cache=None):
    qt, kt, vt = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = compat_flash_attention(qt, kt, vt, torch.tensor(src),
                                 torch.tensor(tgt), mask=torch.tensor(mask),
                                 sigma_d=0.10, compat=cache)
    out.backward(torch.tensor(do))
    return [x.detach().numpy() for x in (out, qt.grad, kt.grad, vt.grad)]


def _assert_grads_close(got, ref, rel, names=("dq", "dk", "dv")):
    for name, g, r in zip(names, got, ref):
        scale = np.abs(r).max()
        err = np.abs(g - r).max()
        assert err <= rel * scale + 1e-7, (name, err, scale)


@pytest.mark.parametrize("masked", [True, False])
def test_streaming_backward_matches_jax_vjp(masked):
    """Streaming mode. gmf_tpu forms distances with the norm identity, the
    port with per-coordinate differences; the identity cancels for close
    pairs, and compat = 1 - dd^2 / sigma^2 amplifies that, so the outputs
    differ by up to 1e-4 (the bound of tests/test_torch_ops.py) and the
    gradients, whose dlogits carry compat once more, by up to 1e-4 of
    their largest entry (measured: 3.9e-5). The cached modes below, on one
    cache, show that the rest agrees to 1e-5."""
    q, k, v, do, src, tgt, mask = _problem(11, masked=masked)
    ref = _jax_vjp(q, k, v, do, src, tgt, mask)
    got = _port_grads(q, k, v, do, src, tgt, mask)
    np.testing.assert_allclose(got[0], ref[0], atol=1e-4)
    _assert_grads_close(got[1:], ref[1:], 1e-4)


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_cached_backward_matches_jax_vjp(dtype, masked):
    """Cached modes with the same cache on both sides: only the order of
    f32 sums differs, so 1e-5 of the largest gradient entry plus 1e-7."""
    q, k, v, do, src, tgt, mask = _problem(12, masked=masked)
    N = q.shape[1]
    jcaches = [jattn.build_compat_cache(
        jnp.asarray(src[b]), jnp.asarray(tgt[b]), sigma_d=0.10,
        dtype=_JAX_DTYPES[dtype], interpret=True) for b in range(q.shape[0])]
    ref = _jax_vjp(q, k, v, do, src, tgt, mask, cache=jcaches)
    got = _port_grads(q, k, v, do, src, tgt, mask,
                      cache=_port_cache(jcaches, N, dtype))
    np.testing.assert_allclose(got[0], ref[0], atol=1e-5)
    _assert_grads_close(got[1:], ref[1:], 1e-5)


@pytest.mark.parametrize("cached", [False, True])
def test_plain_backward_is_autograd_of_plain_forward(cached):
    """In f32, on valid query rows, the kernels' gradient formula equals
    autograd of the plain forward (with do = 0 on masked query rows, whose
    outputs the reference's backward drops) to f32 rounding: 1e-5 of the
    largest entry (measured: 3e-6). On masked query rows dq is exactly
    0."""
    q, k, v, do, src, tgt, mask = _problem(13)
    do = torch.tensor(do * mask[..., None])
    qt, kt, vt = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    m = torch.tensor(mask)
    s, t = torch.tensor(src), torch.tensor(tgt)
    cache = build_compat_cache(s, t, 0.10, torch.float32) if cached else None
    if cached:
        out, lse = compat_attention_cached_plain(qt, kt, vt, cache, m,
                                                 return_lse=True)
    else:
        out, lse = compat_attention_plain(qt, kt, vt, s, t, m,
                                          return_lse=True)
    out.backward(do)
    dq, dk, dv = compat_attention_bwd_plain(
        qt.detach(), kt.detach(), vt.detach(), do, out.detach(),
        lse.detach(), m, s, t, 0.10, compat=cache)
    valid = mask > 0
    assert (dq.numpy()[~valid] == 0).all()
    _assert_grads_close((dq.numpy()[valid], dk.numpy(), dv.numpy()),
                        (qt.grad.numpy()[valid], kt.grad.numpy(),
                         vt.grad.numpy()), 1e-5)


@pytest.mark.parametrize("cached", [False, True])
def test_plain_lse_matches_pallas_forward(cached):
    """The plain forward's base-2 log-sum-exp against the lse that
    gmf_tpu's _forward_call / _forward_call_cached return, on valid rows;
    each valid row's p = exp2(s - lse) sums to 1."""
    q, k, v, _, src, tgt, mask = _problem(14)
    B, N, D = q.shape
    bq, bk = jattn._interpret_blocks()
    Np = jattn._aligned_len(N, bq, bk)

    def pad(x):
        return jnp.pad(jnp.asarray(x), ((0, Np - N),) + ((0, 0),) *
                       (x.ndim - 1))

    s, t, m = torch.tensor(src), torch.tensor(tgt), torch.tensor(mask)
    qt, kt, vt = map(torch.tensor, (q, k, v))
    if cached:
        cache = build_compat_cache(s, t, 0.10, torch.float32)
        _, lse = compat_attention_cached_plain(qt, kt, vt, cache, m,
                                               return_lse=True)
    else:
        _, lse = compat_attention_plain(qt, kt, vt, s, t, m,
                                        return_lse=True)
    for b in range(B):
        mp = jnp.pad(jnp.asarray(mask[b]), (0, Np - N)).reshape(1, Np)
        if cached:
            jc = jattn.build_compat_cache(jnp.asarray(src[b]),
                                          jnp.asarray(tgt[b]), sigma_d=0.10,
                                          dtype=jnp.float32, interpret=True)
            _, jlse = jattn._forward_call_cached(
                pad(q[b]), pad(k[b]), pad(v[b]), jc, mp, 1.0 / D ** 0.5, bq,
                bk, True)
        else:
            sp = jnp.pad(jnp.asarray(src[b]), ((0, Np - N), (0, 125)))
            tp = jnp.pad(jnp.asarray(tgt[b]), ((0, Np - N), (0, 125)))
            _, jlse = jattn._forward_call(
                pad(q[b]), pad(k[b]), pad(v[b]), sp, tp, mp, 0.10 ** 2,
                1.0 / D ** 0.5, bq, bk, True)
        valid = mask[b] > 0
        np.testing.assert_allclose(lse[b].numpy()[valid],
                                   np.asarray(jlse)[:N, 0][valid],
                                   atol=1e-4)
    # p from the lse sums to 1 on every valid row
    c = (_load_compat(cache, N) if cached
         else _stream_compat_plain(s, t, 0.10))
    p = torch.exp2(_logits_plain(qt, kt, c, m) - lse[..., None])
    np.testing.assert_allclose(p.sum(-1).numpy()[mask > 0], 1.0, atol=1e-5)
