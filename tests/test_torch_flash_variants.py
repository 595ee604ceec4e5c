"""The port's attention variants vs scripts/bench_flash_variants.py.

The script's Pallas kernels (``make_variant``, ``make_precompute``) run in
interpret mode on the CPU; the port's wrappers run their plain versions on
CPU tensors. The CUDA instances are held against the same plain versions
on the card by tests/test_torch_cuda.py. The case: B=2 pairs of N=200
correspondences (the script pads them to 256 and masks the padded keys;
the port needs no padding and every key is valid), D=32, the script's
128 x 128 tile, sigma_d 0.10, bf16 q, k, v, keypoints in a 3 m cube with
every other target an inlier (so compat is not all zero). Outputs are
read on [:N].
"""

import functools
import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gmf_tpu_torch.ops.flash_variants import (CACHE_DTYPES, IN_KERNEL,
                                              VARIANTS, flash_variant)
from gmf_tpu_torch.ops.fused_attention import (build_compat_cache,
                                               build_compat_cache_plain,
                                               compat_flash_attention)
from gmf_tpu_torch.tools import bench_flash_variants as bench

torch.set_num_threads(1)
SCRIPT = (Path(__file__).resolve().parents[1]
          / "scripts/bench_flash_variants.py")
B, N, NP, D, TILE = 2, 200, 256, 32, 128
SIGMA_D = 0.10
_JAX_CACHE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


@pytest.fixture(scope="module")
def script():
    """The script as a module. Importing it points JAX's compilation cache
    elsewhere; both settings are put back at once."""
    saved = {k: getattr(jax.config, k) for k in (
        "jax_compilation_cache_dir",
        "jax_persistent_cache_min_compile_time_secs")}
    spec = importlib.util.spec_from_file_location("bench_flash_variants_tpu",
                                                  SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
    return mod


@pytest.fixture
def interpret(script, monkeypatch):
    """The script's pallas_call in interpret mode, as the JAX package's own
    tests run its kernels on the CPU."""
    monkeypatch.setattr(script.pl, "pallas_call", functools.partial(
        script.pl.pallas_call, interpret=True))
    return script


def _problem():
    rng = np.random.RandomState(4)
    q, k, v = (rng.randn(B, N, D).astype(np.float32) for _ in range(3))
    src = (rng.rand(B, N, 3) * 3.0).astype(np.float32)
    tgt = (rng.rand(B, N, 3) * 3.0).astype(np.float32)
    tgt[:, ::2] = src[:, ::2] + 0.01 * rng.randn(B, N // 2, 3).astype(
        np.float32)
    return q, k, v, src, tgt


def _padded_args(script, variant, src, tgt):
    """The script's keypoint operands of ``variant`` for the padded
    problem, built as its main() builds them, and the key mask."""
    sp = jnp.pad(jnp.asarray(src), ((0, 0), (0, NP - N), (0, 125)))
    tp = jnp.pad(jnp.asarray(tgt), ((0, 0), (0, NP - N), (0, 125)))
    mp = jnp.pad(jnp.ones((B, N), jnp.float32),
                 ((0, 0), (0, NP - N)))[:, None, :]
    spT = jnp.transpose(sp[..., :8], (0, 2, 1))
    tpT = jnp.transpose(tp[..., :8], (0, 2, 1))
    if variant in ("v0", "v1", "v6"):
        return (sp, sp, tp, tp), mp
    if variant in CACHE_DTYPES:
        pre = script.make_precompute(TILE, TILE, NP, SIGMA_D ** 2,
                                     _JAX_CACHE[CACHE_DTYPES[variant]])
        cache = jax.vmap(pre)(sp, spT, tp, tpT)
        dummy = jnp.zeros((B, 8, 128), jnp.float32)
        return (cache, dummy, dummy, dummy), mp
    return (sp, spT, tp, tpT), mp


def _pad_bf16(x):
    return jnp.pad(jnp.asarray(x), ((0, 0), (0, NP - N), (0, 0))).astype(
        jnp.bfloat16)


def _bf16(x):
    return torch.tensor(np.asarray(x, np.float32)).to(torch.bfloat16)


def _bf16_ulps(err, ref):
    """``err`` in bf16 ulps (8 significant bits) at the largest |ref|."""
    return err / 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)


@pytest.mark.parametrize("variant", VARIANTS)
def test_variant_matches_pallas_interpret(interpret, variant):
    """One layer of each variant, independent q, k, v. The port's softmax
    differs from the script's in its bf16 roundings (the port rounds
    q * scale * log2(e) and p, the script q, k and p; exp2 against exp),
    so outputs may land on neighbouring bf16 values: within 2 bf16 ulps
    of the largest |out| (measured at most 1). v0 and v6 form the norm
    identity over three coordinates in the port and over 128 padded
    columns in the script; the zeros add nothing, but XLA may sum in
    another order, which the cancellation at close points can show. v4
    and v5 go the benchmark's way: the standalone cache, then the cached
    attention on it."""
    q, k, v, src, tgt = _problem()
    args, mp = _padded_args(interpret, variant, src, tgt)
    call = interpret.make_variant(variant, TILE, TILE, NP, D, SIGMA_D ** 2,
                                  1.0 / D ** 0.5)
    ref = np.asarray(jax.vmap(call)(_pad_bf16(q), _pad_bf16(k),
                                    _pad_bf16(v), *args, mp)[:, :N]
                     .astype(jnp.float32))
    qkv = (_bf16(q), _bf16(k), _bf16(v))
    if variant in CACHE_DTYPES:
        cache = build_compat_cache(torch.tensor(src), torch.tensor(tgt),
                                   SIGMA_D, CACHE_DTYPES[variant])
        got = compat_flash_attention(*qkv, None, None, compat=cache)
    else:
        got = flash_variant(*qkv, torch.tensor(src), torch.tensor(tgt),
                            variant=variant, sigma_d=SIGMA_D)
    assert got.dtype == torch.bfloat16 and got.shape == (B, N, D)
    err = np.abs(got.float().numpy() - ref).max()
    assert _bf16_ulps(err, ref) <= 2.0, (err, np.abs(ref).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_precompute_matches_pallas_interpret(interpret, dtype):
    """The script's compat precompute is the two-sqrt difference form of
    the standalone cache kernel. Its formula (``_compat_bcast``) evaluated
    through eager jnp calls, one rounding per operation, equals the port's
    plain version in every entry. The interpreted kernel is fused by XLA's
    CPU backend, which rounds some operations together, and
    1 - dd^2 / sigma^2 amplifies one ulp of a 3 m distance (2.4e-7) by
    2 dd / sigma^2, up to ~30: f32 within 1e-5 (measured 7.8e-6); bf16
    within one bf16 ulp beneath 1 (2^-8)."""
    _, _, _, src, tgt = _problem()
    args, _ = _padded_args(interpret, "v5" if dtype == torch.float32
                           else "v4", src, tgt)
    ref = np.asarray(args[0][:, :N, :N].astype(jnp.float32))
    got = build_compat_cache_plain(torch.tensor(src), torch.tensor(tgt),
                                   SIGMA_D, dtype)[:, :, :N].float().numpy()
    assert 0.02 < (ref > 0).mean() < 0.9  # compat is not all zero
    for b in range(B):
        s, t = jnp.asarray(src[b]), jnp.asarray(tgt[b])
        eager = interpret._compat_bcast(s, s.T, t, t.T, SIGMA_D ** 2,
                                        single_sqrt=False)
        np.testing.assert_array_equal(
            got[b], np.asarray(eager.astype(_JAX_CACHE[dtype])
                               .astype(jnp.float32)))
    err = np.abs(got - ref).max()
    assert err <= (1e-5 if dtype == torch.float32 else 2.0 ** -8), err


@pytest.mark.parametrize("variant", ["v0", "v5"])
def test_two_layer_stack_matches_script_pattern(interpret, variant):
    """The benchmark's x -> attn(x, x, x) stack, two layers, through the
    port's layers against the script's loop over its kernel. Each query
    attends mostly to itself (q = k), so |out| is ~4 and the roundings of
    the two softmaxes stay within 2 bf16 ulps of it (measured 0.75)."""
    q, _, _, src, tgt = _problem()
    args, mp = _padded_args(interpret, variant, src, tgt)
    call = interpret.make_variant(variant, TILE, TILE, NP, D, SIGMA_D ** 2,
                                  1.0 / D ** 0.5)
    x = _pad_bf16(q)
    for _ in range(2):
        x = jax.vmap(call)(x, x, x, *args, mp)
    ref = np.asarray(x[:, :N].astype(jnp.float32))
    if variant in CACHE_DTYPES:
        cache = build_compat_cache_plain(torch.tensor(src),
                                         torch.tensor(tgt), SIGMA_D,
                                         CACHE_DTYPES[variant])
        layer = functools.partial(bench.cached_layer, cache=cache)
    else:
        layer = functools.partial(bench.variant_layer, variant=variant,
                                  src=torch.tensor(src),
                                  tgt=torch.tensor(tgt))
    got = bench.stack(layer, _bf16(q), 2).float().numpy()
    err = np.abs(got - ref).max()
    assert _bf16_ulps(err, ref) <= 2.0, (err, np.abs(ref).max())


def test_flash_variant_takes_in_kernel_variants_only():
    """flash_variant forms compat in the kernel; v4 and v5 stream a cache
    and are refused with the route they take, an unknown name too."""
    assert set(IN_KERNEL) | set(CACHE_DTYPES) == set(VARIANTS)
    q, k, v, src, tgt = _problem()
    args = (_bf16(q), _bf16(k), _bf16(v), torch.tensor(src),
            torch.tensor(tgt))
    for variant in CACHE_DTYPES:
        with pytest.raises(ValueError, match="compat=cache"):
            flash_variant(*args, variant=variant)
    with pytest.raises(ValueError, match="not in"):
        flash_variant(*args, variant="v7")


def test_bench_runs_on_cpu(capsys):
    """The entry point at a tiny size on the CPU: a line per variant and
    for the library, then the JSON line. v2 and v5 compute the same compat
    as v0 up to the form of the distances, so their outputs stay close."""
    res = bench.main(["--num-corr", "70", "--batch", "2", "--layers", "2",
                      "--iters", "1", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split()[0] for ln in lines[:-1]] == [*VARIANTS, "sdpa"]
    assert json.loads(lines[-1]) == res
    assert res["device"] == "cpu" and res["timer"] == "host clock"
    assert set(res["variants"]) == set(VARIANTS)
    for variant, row in res["variants"].items():
        assert row["ms_per_stack"] > 0 and row["peak_memory_bytes"] is None
        assert ("precompute_ms" in row) == (variant in CACHE_DTYPES)
        drift = row["max_abs_diff_vs_v0"]
        assert (drift is None) == (variant == "v1")
        assert drift is None or drift < 0.1
    assert res["variants"]["v0"]["max_abs_diff_vs_v0"] == 0.0
    # the library's attention computes v1's function: after one layer
    # within 2 bf16 ulps of the largest output (the two round q * scale
    # and p to bf16 at other places)
    sdpa = res["sdpa"]
    assert sdpa["one_layer_max_abs_diff_vs_v1"] <= 2 * 2.0 ** (
        np.floor(np.log2(sdpa["one_layer_v1_max_abs_out"])) - 7)
    assert sdpa["max_abs_diff_vs_v1"] < 0.5
