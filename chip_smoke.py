"""Drive gmf_tpu_torch on one NVIDIA GPU and check its CUDA kernels.

    python3 chip_smoke.py [--out PATH]

Needs one CUDA card and the CUDA toolkit (nvcc); the kernels are built
from gmf_tpu_torch/ops/csrc on the way. Phases, any failure exits non-zero:

1. Print the card's name and power limit (nvidia-smi).
2. Build the kernels (one nvcc per source, in parallel).
3. Hold each kernel against its plain PyTorch version on the card at the
   main path's shapes: B=8 pairs, N=5000 (4000 valid rows in pair 0),
   D=128, S=500 seeds, k+1=41. Attention runs in f32 and bf16.
4. Serve 3 register_batch requests of 8 synthetic pairs each through
   PointDSCRegistrar at full width (12 layers, 128 channels, k=40,
   ratio 0.1, 120x160 images, bucket 5000; bf16 modules, f32 geometry).
   Launch counts are reset just before and read just after: each forward
   must launch 12 attention kernels and one of each other kernel.
5. Serve one request with f32 modules twice, on the card through the
   kernels and on the CPU through the plain versions, with the same
   weights and inputs, and compare final transforms and labels.
6. Print a JSON line with every kernel's launches, time, plain time,
   bound and error; a line with the registrar's time per request; and, as
   the last line, {"ok": true, "device": {...}}.

Times are CUDA-event means after warm-up (kernels) and host-clock means
of synchronised requests (registrar).
"""

from __future__ import annotations

import argparse
import copy
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

B, N, N_VALID0, D, S, K1 = 8, 5000, 4000, 128, 500, 41
IMAGE_HW = (120, 160)
SEED = 0
KERNELS = ("compat_flash_attention", "nms_local_max", "seed_knn_topk",
           "seed_hypothesis_counts")
SOURCES = {name: f"gmf_tpu_torch/ops/csrc/{name}.cu" for name in KERNELS}
REPLACES = {
    "compat_flash_attention": "gmf_tpu/ops/fused_attention.py:241",
    "nms_local_max": "gmf_tpu/ops/fused_nms.py:69",
    "seed_knn_topk": "gmf_tpu/ops/fused_topk.py:108",
    "seed_hypothesis_counts": "gmf_tpu/ops/fused_scoring.py:138",
}
PER_FORWARD = {"compat_flash_attention": 12, "nms_local_max": 1,
               "seed_knn_topk": 1, "seed_hypothesis_counts": 1}

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, dense bf16 tensor-core
# FLOP/s, f32 FLOP/s outside the tensor cores (an FMA is 2 FLOP).
HBM_BPS = 3.35e12
BF16_TC_FLOPS = 989e12
F32_FLOPS = 67e12
SFU_PER_CLK_PER_SM = 16   # Hopper: 4 SFU quads per SM
ALU_PER_CLK_PER_SM = 128  # f32 lanes per SM


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def nvidia_smi(query: str) -> str:
    r = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        fail(f"nvidia-smi: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


class Rates:
    """Per-second peaks of this card for the bound."""

    def __init__(self):
        props = torch.cuda.get_device_properties(0)
        self.sms = props.multi_processor_count
        mhz = float(nvidia_smi("clocks.max.sm").split()[0])
        self.clock_hz = mhz * 1e6
        self.alu = ALU_PER_CLK_PER_SM * self.sms * self.clock_hz
        self.sfu = SFU_PER_CLK_PER_SM * self.sms * self.clock_hz

    def bound(self, nbytes, terms):
        """(bound_ms, bound_by): the larger of the byte time and the
        largest operation time in ``terms`` ({name: seconds})."""
        t_bytes = nbytes / HBM_BPS
        t_ops = max(terms.values())
        return ((max(t_bytes, t_ops) * 1e3),
                "bytes" if t_bytes >= t_ops else "operations")


def bf16_ulp(x: float) -> float:
    """Spacing of bf16 values (8 significant bits) at |x|."""
    return 2.0 ** (math.floor(math.log2(abs(x))) - 7)


def make_inputs(dev):
    from gmf_tpu_torch.data.synthetic import make_correspondence_problem

    prob = make_correspondence_problem(np.random.RandomState(SEED),
                                       num_corr=N, inlier_ratio=0.4,
                                       image_hw=(8, 8), batch=B)
    src = torch.tensor(prob["src_keypts"], device=dev)
    tgt = torch.tensor(prob["tgt_keypts"], device=dev)
    mask = torch.ones(B, N, device=dev)
    mask[0, N_VALID0:] = 0.0
    return prob, src, tgt, mask


def kernel_phase(dev, rates):
    """Phase 3: every kernel vs its plain version at main-path shapes."""
    from gmf_tpu_torch.ops.fused_attention import (compat_attention_plain,
                                                   compat_flash_attention)
    from gmf_tpu_torch.ops.fused_nms import (nms_local_max,
                                             nms_local_max_plain)
    from gmf_tpu_torch.ops.fused_scoring import (
        seed_hypothesis_counts, seed_hypothesis_counts_plain)
    from gmf_tpu_torch.ops.fused_topk import (seed_knn_topk,
                                              seed_knn_topk_plain)

    gen = torch.Generator(device=dev).manual_seed(SEED)
    prob, src, tgt, mask = make_inputs(dev)
    rows = {}

    # -- attention, f32 and bf16 ---------------------------------------
    pairs = B * N * N
    att = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (torch.randn(B, N, D, generator=gen, device=dev).to(dtype)
                   for _ in range(3))
        got = compat_flash_attention(q, k, v, src, tgt, mask=mask)
        ref = compat_attention_plain(q, k, v, src, tgt, mask=mask)
        err = (got.float() - ref.float()).abs().max().item()
        ref_max = ref.float().abs().max().item()
        # f32: the two differ by summation order and the running max only.
        # bf16: the plain version rounds q*scale and p as the kernel does,
        # and both round the output to bf16, so an output may land on the
        # neighbouring bf16 value: 2 ulps at the largest output hold that
        # and the f32 differences beneath it.
        tol = 1e-5 if dtype == torch.float32 else 2 * bf16_ulp(ref_max)
        if not err <= tol:
            fail(f"compat_flash_attention {dtype}: max abs err {err} > {tol}")
        ms = cuda_ms(lambda: compat_flash_attention(q, k, v, src, tgt,
                                                    mask=mask), reps=5)
        plain_ms = cuda_ms(lambda: compat_attention_plain(
            q, k, v, src, tgt, mask=mask), reps=2, warmup=1)
        esize = torch.finfo(dtype).bits // 8
        nbytes = 4 * B * N * D * esize + B * N * (3 + 3 + 1) * 4
        mm_rate = BF16_TC_FLOPS if dtype == torch.bfloat16 else F32_FLOPS
        bound_ms, bound_by = rates.bound(nbytes, {
            "products": 4 * D * pairs / mm_rate,      # q.k and p.v
            "compat_alu": 20 * pairs / rates.alu,     # ~20 f32 ops / pair
            "sfu": 3 * pairs / rates.sfu,             # 2 sqrt + 1 exp2
        })
        att[dtype] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by=bound_by, tol=tol,
                          ref_max=ref_max)
        del q, k, v, got, ref
        torch.cuda.empty_cache()
    b16, f32 = att[torch.bfloat16], att[torch.float32]
    rows["compat_flash_attention"] = dict(
        dtype="bf16", **{k: b16[k] for k in ("max_abs_err", "ms", "plain_ms",
                                             "bound_ms", "bound_by")},
        tolerance=b16["tol"], max_abs_ref=b16["ref_max"],
        f32_max_abs_err=f32["max_abs_err"],
        f32_ms=f32["ms"], f32_plain_ms=f32["plain_ms"],
        f32_bound_ms=f32["bound_ms"], f32_tolerance=f32["tol"])

    # -- NMS -------------------------------------------------------------
    scores = torch.randn(B, N, generator=gen, device=dev)
    got = nms_local_max(src, scores, 0.10)
    ref = nms_local_max_plain(src, scores, 0.10)
    err = (got - ref).abs().max().item()
    if err != 0:
        fail(f"nms_local_max disagrees with its plain version ({err})")
    n_max = int(ref.sum().item())
    needed = n_max * N + (B * N - n_max)  # maxima scan all keys
    rows["nms_local_max"] = dict(
        max_abs_err=err, tolerance=0.0,
        ms=cuda_ms(lambda: nms_local_max(src, scores, 0.10), reps=10),
        plain_ms=cuda_ms(lambda: nms_local_max_plain(src, scores, 0.10),
                         reps=3, warmup=1),
        local_maxima=n_max,
        **dict(zip(("bound_ms", "bound_by"), rates.bound(
            B * N * 4 * 5, {"alu": 10 * needed / rates.alu}))))

    # -- seed kNN ----------------------------------------------------------
    feats = torch.randn(B, N, D, generator=gen, device=dev)
    feats = feats / feats.norm(dim=-1, keepdim=True)
    seed_idx = torch.randperm(N_VALID0, generator=gen, device=dev)[:S]
    seeds = feats[:, seed_idx].contiguous()
    got_i, got_v = seed_knn_topk(seeds, feats, K1, mask=mask)
    ref_i, ref_v = seed_knn_topk_plain(seeds, feats, K1, mask=mask)
    # near-ties (score gaps below f32 summation-order error) may swap
    # neighbours between the two; the chosen scores must agree
    full = torch.matmul(seeds, feats.transpose(-1, -2))
    full = torch.where(mask[:, None] > 0, full, torch.full_like(full,
                                                               -math.inf))
    err = (full.gather(-1, got_i.long()) - ref_v).abs().max().item()
    if not err <= 1e-5:
        fail(f"seed_knn_topk: chosen scores differ by {err}")
    rows["seed_knn_topk"] = dict(
        max_abs_err=err, tolerance=1e-5,
        index_agreement=(got_i == ref_i).float().mean().item(),
        ms=cuda_ms(lambda: seed_knn_topk(seeds, feats, K1, mask=mask),
                   reps=10),
        plain_ms=cuda_ms(lambda: seed_knn_topk_plain(seeds, feats, K1,
                                                     mask=mask),
                         reps=3, warmup=1),
        **dict(zip(("bound_ms", "bound_by"), rates.bound(
            (B * S * D + B * N * D + B * N) * 4 + B * S * K1 * 8,
            {"products": 2 * B * S * N * D / F32_FLOPS,
             "select": B * S * N / rates.alu}))))
    del full, feats, seeds

    # -- hypothesis scoring ------------------------------------------------
    rng = np.random.RandomState(SEED + 1)
    T = np.repeat(prob["gt_trans"][:, None], S, axis=1).copy()
    for b in range(B):
        for s in range(S):
            a = 0.02 * rng.randn(3)
            Rx = np.array([[1, 0, 0], [0, np.cos(a[0]), -np.sin(a[0])],
                           [0, np.sin(a[0]), np.cos(a[0])]])
            Rz = np.array([[np.cos(a[2]), -np.sin(a[2]), 0],
                           [np.sin(a[2]), np.cos(a[2]), 0], [0, 0, 1]])
            T[b, s, :3, :3] = (Rx @ Rz) @ T[b, s, :3, :3]
            T[b, s, :3, 3] += 0.02 * rng.randn(3)
    trans = torch.tensor(T.astype(np.float32), device=dev)
    got = seed_hypothesis_counts(trans, src, tgt, 0.10, mask=mask)
    ref = seed_hypothesis_counts_plain(trans, src, tgt, 0.10, mask=mask)
    err = (got - ref).abs().max().item()
    # the two residual forms round differently only at the d == thr edge
    if not err <= 2:
        fail(f"seed_hypothesis_counts: counts differ by {err}")
    rows["seed_hypothesis_counts"] = dict(
        max_abs_err=err, tolerance=2, mean_count=got.float().mean().item(),
        ms=cuda_ms(lambda: seed_hypothesis_counts(trans, src, tgt, 0.10,
                                                  mask=mask), reps=10),
        plain_ms=cuda_ms(lambda: seed_hypothesis_counts_plain(
            trans, src, tgt, 0.10, mask=mask), reps=3, warmup=1),
        **dict(zip(("bound_ms", "bound_by"), rates.bound(
            B * S * 64 + B * N * 28 + B * S * 4,
            {"alu": 16 * B * S * N / rates.alu}))))
    return rows


def main_path_registrar(dev, dtype=torch.bfloat16):
    """The main path's model at full width (random weights from SEED)
    behind a registrar with the one bucket N."""
    from gmf_tpu_torch.eval.registration import PointDSCRegistrar
    from gmf_tpu_torch.models import PointDSC

    model = PointDSC(num_layers=12, num_channels=128, k=40, ratio=0.1,
                     compat_cache="off", dtype=dtype, device=dev, seed=SEED)
    return PointDSCRegistrar(model, buckets=(N,))


def make_requests():
    """3 requests of 8 synthetic pairs; request 1 has N from 4000-5000."""
    from gmf_tpu_torch.data.synthetic import make_correspondence_problem

    rng = np.random.RandomState(SEED)
    requests = []
    for r in range(3):
        prob = make_correspondence_problem(rng, num_corr=N, inlier_ratio=0.4,
                                           image_hw=IMAGE_HW, batch=B)
        samples = [{k: v[b] for k, v in prob.items()} for b in range(B)]
        if r == 1:
            for s in samples:
                n = int(rng.randint(4 * N // 5, N + 1))
                for key in ("corr_pos", "src_keypts", "tgt_keypts",
                            "labels"):
                    s[key] = s[key][:n]
        requests.append(samples)
    return requests


def rot_err_deg(Ta, Tb):
    c = (np.trace(Ta[:3, :3].T @ Tb[:3, :3]) - 1.0) / 2.0
    return math.degrees(math.acos(min(1.0, max(-1.0, c))))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the result JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")

    from gmf_tpu_torch.eval.registration import PointDSCRegistrar
    from gmf_tpu_torch.ops import _build

    # 1. the card
    card = nvidia_smi("name,power.limit")
    print(card, flush=True)
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    rates = Rates()

    # 2. build
    t0 = time.perf_counter()
    _build.build(verbose=True)
    _build.load()
    build_s = time.perf_counter() - t0
    print(f"kernels built in {build_s:.1f} s", flush=True)

    # 3. kernels vs plain
    rows = kernel_phase(dev, rates)
    print("kernel checks passed", flush=True)

    # 4. the main path at full width
    reg = main_path_registrar(dev)
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    requests = make_requests()
    _build.reset_launches()
    results = [reg.register_batch(req) for req in requests]
    torch.cuda.synchronize()
    launches = {name: _build.launches[name] for name in KERNELS}
    for name in KERNELS:
        want = PER_FORWARD[name] * len(requests)
        if launches[name] != want:
            fail(f"{name}: {launches[name]} launches on the main path, "
                 f"expected {want}")
    rot, trn, ok = [], [], 0
    for req, res in zip(requests, results):
        for s, (trans, labels) in zip(req, res):
            if trans.shape != (4, 4) or not np.isfinite(trans).all():
                fail("non-finite or misshapen transform")
            if labels.shape != (s["corr_pos"].shape[0],):
                fail("labels of the wrong length")
            re_ = rot_err_deg(trans, s["gt_trans"])
            te = float(np.linalg.norm(trans[:3, 3] - s["gt_trans"][:3, 3]))
            rot.append(re_)
            trn.append(te)
            ok += re_ < 15.0 and te < 0.30
    print(f"main path: {len(rot)} pairs, registration recall "
          f"{ok}/{len(rot)}, median rot err {np.median(rot):.4f} deg, "
          f"median trans err {np.median(trn):.5f} m", flush=True)

    # registrar time per request, after the counted (warm-up) run
    times = []
    for req in requests:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reg.register_batch(req)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    ms_req = 1e3 * float(np.mean(times))

    # 5. f32 slice: kernels on the card vs plain versions on the CPU
    reg32 = main_path_registrar(dev, torch.float32)
    cpu_model = copy.deepcopy(reg32.model).to("cpu")
    torch.set_num_threads(8)
    t0 = time.perf_counter()
    got = reg32.register_batch(requests[0])
    ref = PointDSCRegistrar(cpu_model, buckets=(N,)).register_batch(
        requests[0])
    cpu_s = time.perf_counter() - t0
    trans_err = [float(np.abs(g[0] - r[0]).max()) for g, r in zip(got, ref)]
    agree = [float((g[1] == r[1]).mean()) for g, r in zip(got, ref)]
    print(f"f32 slice, kernels (card) vs plain (CPU), {cpu_s:.1f} s: "
          f"max |dT| per pair {trans_err}, label agreement {agree}",
          flush=True)
    # bound of the CPU parity tests (tests/test_torch_model.py,
    # tests/test_fused_model.py): final_trans atol 1e-3, labels >= 0.99
    if max(trans_err) > 1e-3 or min(agree) < 0.99:
        fail("f32 slice through the kernels disagrees with the plain "
             "versions")

    kernels = []
    for name in KERNELS:
        r = rows[name]
        kernels.append(dict(
            name=name, route="cuda", source=SOURCES[name],
            replaces=REPLACES[name], launches=launches[name],
            launches_per_forward=PER_FORWARD[name],
            max_abs_err=r.pop("max_abs_err"), ms=r.pop("ms"),
            plain_ms=r.pop("plain_ms"), bound_ms=r.pop("bound_ms"),
            bound_by=r.pop("bound_by"), library_ms=None, **r))
    result = {"kernels": kernels}
    serve = {"registrar_ms_per_request": ms_req,
             "pairs_per_s": B * 1e3 / ms_req, "pairs_per_request": B,
             "bucket": N, "build_s": build_s,
             "f32_slice_max_trans_err": max(trans_err),
             "f32_slice_min_label_agreement": min(agree),
             "card": card, "sm_clock_max_hz": rates.clock_hz}
    if args.out:
        with open(args.out, "w") as f:
            json.dump({**result, "serve": serve}, f, indent=1)
    print(json.dumps(serve), flush=True)
    print(json.dumps(result), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
