"""Drive gmf_tpu_torch on one NVIDIA GPU and check its CUDA kernels.

    python3 chip_smoke.py [--out PATH]

Needs one CUDA card and the CUDA toolkit (nvcc); the kernels are built
from gmf_tpu_torch/ops/csrc on the way. Phases, any failure exits non-zero:

1. Print the card's name and power limit (nvidia-smi).
2. Build the kernels (one nvcc per source, in parallel).
3. Hold each of the seventeen kernels (the seed kNN's two instances
   count apart) against its plain PyTorch version on the card at its
   path's shapes. The eight forward kernels at the serving
   path's shapes: B=8 pairs, N=5000 (4000 valid rows in
   pair 0), D=128, S=500 seeds, k=40. Attention runs in f32 and bf16, the
   compat cache in f32, bf16 and int8. The int8 cache of the build+attend
   kernel, of the standalone cache kernel and of the plain version must agree
   in every byte, and the build+attend output must equal the cached
   kernel's on that cache. Every standalone cache must also equal its
   transpose, hold zeros in its pad columns and come out the same from a
   second launch (cache_checks); its bound counts the unordered pairs,
   the bound over all entries beside it (cache_bound). Then the five
   kernels of the main path once more at that path's B=64 (bf16
   attention, every pair with its own
   count of valid rows), with the same limits, their plain versions run
   in slices of 8 pairs; NMS at both sizes timed (its call, its sort and
   its scan) beside its plain version and the bound of the work NMS needs
   (a local maximum against the keys within the radius). The seed kNN in
   both its instances (bf16 on the tensor cores, the main path's; f32 on
   the CUDA cores, training's) on unit features rounded to the instance's
   type, its plain version fed the same values, at B=8 and at B=64, each timed beside its plain
   version at both; the seed solver on each instance's features (bf16,
   the served model's, and f32) and the neighbourhoods it chose, at both,
   timed; the hypothesis counts equal to their plain version in every
   count, two launches equal, at B=8, at B=64 and at 16 x 1000, timed at
   each. Then the bf16 forward core (core_phase) in each
   of its modes (streaming, build+attend, cached on int8, bf16 and f32
   caches, no compat) at D=32 and 128 and N in 1, 63-65, 127-129, 333,
   5000, with masked keys inside a tile and a pair whose keys are all
   masked, and across the pair boundary (the next pair's k and v all
   inf), output and lse against the plain version with the limits above.
   The same for the f32 core (the three-term split on the tensor cores)
   in each mode and the variants v0, v3, v6 at N in 1, 31-33, 64, 65,
   333, 1000, with two launches equal in every bit and p recomputed from
   its lse summing to 1 within 1e-5. Then every kernel of the training
   paths at the training shape, B=16, N=1000, D=128 with the last 10% of
   pair 0 masked, f32 and bf16: the four backward kernels (dK/dV and dQ,
   streaming and cached, the cached ones on each cache type, launched
   twice for the same bits, in f32 held to twice the plain f32
   backward's distance from the backward in f64, and across the pair
   boundary: pair 0 at N=333, pair 1's k, v, do and, streaming, its
   keypoints all inf), the streaming and cached
   forward (output and the lse they write; the f32 ones timed beside
   their bound and held to twice the plain f32 version's distance from
   the attention in f64), the standalone cache of each type (every
   byte, its transpose, zero pads, two launches equal; timed), kNN and
   counts at S=100 seeds, each against its plain version with the limits
   above. Then the
   attention-variant microbenchmark (variants_phase): the four instances
   of compat_flash_variants.cu (v0, v1, v3, v6) against their plain
   version at B=8, N=5000 in f32 and bf16 and at N=333, with the limits
   above; the benchmark itself (gmf_tpu_torch.tools.bench_flash_variants)
   at its full size, 64 pairs of N=5000, 12 layers, 3 timed stacks per
   variant and the library's attention beside v1, its launch counts reset
   just before it and read just after it; and one layer of each
   variant's kernel on the benchmark's own input (64 x 5000, q = k = v)
   against its plain version run in slices of 8 pairs, with the limits
   above, v4 and v5's caches every byte (and cache_checks), timed.
4. Serve register_batch requests through PointDSCRegistrar at full width
   (12 layers, 128 channels, k=40, ratio 0.1, 120x160 images, bucket 5000;
   bf16 modules, f32 geometry). Launch counts are reset just before each
   path and read just after it:
   - main path, the bench default: 3 requests of 64 pairs with the int8
     compat cache (1 build+attend and 11 cached attention launches per
     forward, no streaming launch, one of NMS, kNN and counts);
   - compat_cache="auto" at 8 pairs, which resolves to the f32 cache
     (1 standalone cache build and 12 cached launches);
   - compat_cache="off" at 8 pairs (12 streaming launches);
   - compat_cache="int8" with seed_solver="fused" at 8 pairs (1 solver
     launch), its transforms held against seed_solver="xla" on every pair
     where the same seed won;
   - fused_attention=False at 8 pairs (dense_b8), the reference's dense
     path: the [8, 5000, 5000] f32 compat and dense attention in every
     layer, dense NMS; no attention or NMS launch, one of kNN and counts.
   Then the raw-descriptor path (raw_b16): 2 requests of 16 pairs drawn
   from 8 synthetic fragments of 5000 keypoints with 32-d unit
   descriptors, matched on the card in the model's call, through
   dispatch_batch/fetch_batch and a DeviceFragmentCache (int8 cache, bf16
   modules; the main path's launches a forward): cache hits on the second
   request, the transforms equal to register_batch's on the same pairs
   without the cache, and the matched rows equal to build_correspondences
   on the host.
   Then train through Trainer.train_step at the reference's 3DMatch
   configuration (16 pairs of N=1000 per step, 120x160 images, the same
   full-width model, f32, Adam), counts reset before each path:
   - the training main path, compat_cache="auto" (the f32 cache): 2
     warm-up and 3 timed steps, per step 1 standalone cache build and 12
     launches each of the cached forward, dK/dV and dQ kernels, and one
     of kNN and counts;
   - compat_cache="off": 12 each of the streaming forward and its two
     backward kernels per step; compat_cache="int8": the cached kernels
     on int8 codes;
   - fused_attention=False (train_dense), the reference's default
     training: 5 steps, no attention kernel, one of kNN (f32) and counts
     a step. Every step applied, every loss finite.
5. Serve one request of 8 pairs with f32 modules on the card through the
   kernels and on the CPU through the plain versions, with the same
   weights and inputs, and compare final transforms and labels: with the
   int8 cache and with compat_cache="off" (these two at CUT_LAYERS = 2
   layers), and on the dense path (fused_attention=False, 12 layers).
   The same request with bf16
   modules and the int8 cache, the serving path's numerics, held on the
   pairs where the same correspondence's seed won on both (the two
   devices round bf16 apart; bf16_slice_check). Then where that request
   parts on the two devices (bf16_seed_stage_check): each step of the
   seed stage run on the CPU from the card's own inputs to it, one line a
   step (the encoder output's distance in bf16 ulps, NMS seeds, kNN
   indices, seed transforms, counts, winners, and the card's winner among
   the CPU's tied seeds), every step that runs a kernel held to its plain
   version, and the CPU's seed stage from the card's encoder output held
   to the card's winner on every pair. Take one f32 train step of 16
   pairs of N=1000 on the card and on the CPU, same weights and batch,
   "auto", "off" (at CUT_LAYERS = 2 layers) and the dense path: the loss
   and each parameter's gradient against the same step in f64 on the
   CPU, within the CPU tests' bound on that
   parameter's own scale or twice the CPU's own f32 error there, and the
   new parameters against Adam's update from the card's gradient
   (compare_train_step; scripts/check_train_faults.py shows that planted
   backward faults fail it).
6. Run the training command line twice (synthetic data, one epoch of two
   steps): without --fused (dense attention, the reference's default) and
   with it; each snapshot's config must record the mode.
7. The evaluation stack at full width (12 layers, 128 channels, k=40,
   random weights from SEED saved as a port checkpoint), on fixtures the
   script writes into a temporary directory (PNG frames by its own
   writer: the card's machine has no imaging package), the launch counts
   reset before each run and read after it:
   - test_3dmatch on one 3DMatch scene (6 fragments of 5000 keypoints,
     32-d descriptors, 480 x 640 frames, a gt.log of 8 pairs) at --batch
     4 --inflight 2 --workers 2 through main(argv) (the f32 cache: per
     forward 1 standalone cache, 12 cached attention, 1 each of NMS, kNN
     and counts), then with --device-match as `python -m` in a
     subprocess (exit code, statistics, recall);
   - test_kitti on 8 pairs of 12000 correspondences (12500 points a
     cloud, KITTI's 376 x 1241 camera frames) in one batch of 8 with
     RANSAC and ICP (the int8 cache);
   - test_3dlomatch --num-node all on one pair of 19000-keypoint
     fragments whose mutual matches pass 16384: NMS called once on the
     20480 bucket (its merge pass), that call held to its plain version
     in every bit and timed beside its bound (nms_check);
   - train_pointdsc --dataset 3DMatch --max-epoch 1 --steps-per-epoch 2
     --prefetch 2 (dense, f32: 1 kNN and 1 counts launch a forward, 4
     forwards), every metric finite;
   - RegistrationService (int8 cache, bf16 modules, max_batch 16): 4
     client threads submit 32 pairs of 5000 correspondences; every
     flush run again through register_batch on the same pairs gives the
     same transforms and labels in every bit; the main path's launches
     a flush.
   Each run: all_stats.npy of [pairs, 12] finite columns, registration
   recall >= 0.9 (the service's too), the launch counts asserted.
8. DGR+GMF registration (dgr_phase) at full width (FCGF 1 -> 32, conv1
   7^3, 5^3 for KITTI; the 6-D GMF inlier net, image_dim 128, 120 x 160
   frames), random weights from SEED, on make_dgr_pair's surface scaled
   up; no TPU kernel lies on this path, so it adds no kernel row. The
   card's default path builds its kernel maps on the card
   (sparse/device_maps.py) and runs the 6-D inlier net on compacted
   schedules (sparse/compact.py), as gmf_tpu does off the CPU:
   - FPFH of a ~1,500-voxel pair on the card and the CPU (rows apart by
     a bin flip and 1-NN matches apart each under 2%), then register() on
     both devices, the same weights, the CPU on device maps and compacted
     convolutions too: nn01 equal, weights within 1e-4, the same
     safeguard decision, T within 1e-4 rad and m (5e-4 with ICP); fcgf,
     fpfh and fpfh with ICP (the CPU fed the card's FPFH); at that pair
     every array of the card's device pyramids (3-D and 6-D, compacted
     and not) equal to the CPU's device pyramids and, uncompacted, to
     the native host builder's;
   - register() with ICP at ~20,000 voxels at 3DMatch's voxel 0.05 and
     KITTI's 0.3 on the default path, and at 3DMatch once more with host
     maps and dense convolutions (device_kernel_maps=False), the two in
     turns: host-clock means of synchronised calls, one line a stage
     (voxelize, the 3-D and 6-D pyramids, FCGF, 1-NN, unique, inlier
     net, solve, the safeguard timed alone, ICP), peak memory, each 6-D
     map's K', M and non-sentinel share and the compacted schedules'
     rows; no map of the default path from a host builder, every map of
     the host path from the native one; the full-size 6-D device maps
     equal to the native builder's in every bit;
   - test_dgr through main(argv) on a 3DMatch tree (PLY fragments, PNG
     frames, gt.log) and a KITTI sequence (velodyne .bin, poses,
     calibration) the script writes: full width with --descriptor fpfh
     --use-icp on the card (finite rows), and --tiny --descriptor fpfh
     --use-icp on the card and with --cpu (success and safeguard flags
     equal, rre within 0.05 deg, rte within 1e-3 m); the tiny FCGF's
     features on both devices within 1e-4.
9. DGR+GMF training (dgr_train_phase), phase 8's nets, no kernel row:
   - one SGD train_step of 2 pairs on the card and on the CPU at ~1,500
     voxels (the CPU on the card's 1-NN matches and labels, its own
     descriptors held to the card's): labels equal, each pair's loss
     within 1e-5 relative and every gradient leaf, the running
     statistics, the momentum buffers and the updated parameters within
     the stated limits; the image encoder's backward on each device held
     to f64 on the CPU; the loss's hard decisions (weights at the clip,
     ws at 10, the arccos clip) counted;
   - WeightedProcrustesTrainer at 3DMatch scale (~20,000 voxels a cloud,
     4 pairs a step, dgr_3dmatch's SGD): a warm-up step of 2 pairs and 2
     timed steps,
     ms a step, the per-pair split (descriptors, 6-D pyramid, forward
     and backward; the update a step), peak memory, no step skipped, the
     loss finite, the parameters moved;
   - ContrastiveDescriptorTrainer on the full-width FCGF at that scale,
     ms a pair and peak memory;
   - register() with bf16 nets at 3DMatch scale, timed; at ~1,500 voxels
     the card's bf16 inlier logits no farther from its f32 logits than
     1.5x the CPU's;
   - train_dgr --tiny on the card, 1 epoch of 2 steps; its checkpoint
     loads through load_dgr into an engine that registers a pair.
10. Print the seconds of each phase as it ends, a JSON line with every
    path's time per request or step, a JSON
    line with every kernel's launches, time, plain time, bound and error,
    and, as the last line, {"ok": true, "device": {...}}.

Times are CUDA-event means after warm-up (kernels) and host-clock means
of synchronised requests (registrar) and steps (trainer).
"""

from __future__ import annotations

import argparse
import collections
import copy
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

# the attention variants' own instances: v0, v1, v3, v6 of the
# attention-variant microbenchmark, by variant
from gmf_tpu_torch.ops.flash_variants import KERNELS as VARIANT_KERNELS
# the seed kNN's two instances, by the features' dtype
from gmf_tpu_torch.ops.fused_topk import KERNELS as KNN_KERNELS

B, N, N_VALID0, D, S, K1 = 8, 5000, 4000, 128, 500, 41
B_MAIN = 64  # pairs per request on the main path (the bench default)
# the depth of three CPU checks of earlier paths (the f32 slices with the
# int8 cache and "off", the "off" train step), cut from 12 layers to keep
# the run's time as the dense and raw paths' checks joined it; the bf16
# int8 request, the dense slice and the "auto" and dense train steps stay
# at full depth. At 2 layers every kernel of those paths still runs
# (build+attend then cached; streaming forward and backward)
CUT_LAYERS = 2
IMAGE_HW = (120, 160)
SEED = 0
SEED_SIGMA = 1.2  # feature sigma of the seed-solver check (learned, ~1)
NUM_ITERS = 10
KERNELS = ("compat_flash_attention", "build_compat_cache",
           "compat_flash_attention_build", "compat_flash_attention_cached",
           "nms_local_max", *KNN_KERNELS.values(), "seed_hypothesis_counts",
           "fused_seed_weights", "compat_flash_attention_bwd_dkv",
           "compat_flash_attention_bwd_dq",
           "compat_flash_attention_cached_bwd_dkv",
           "compat_flash_attention_cached_bwd_dq",
           *VARIANT_KERNELS.values())
BWD_KERNELS = KERNELS[9:13]
SOURCES = {name: f"gmf_tpu_torch/ops/csrc/{name}.cu" for name in KERNELS}
# one source holds a dK/dV and a dQ kernel, or a kernel's instances
for _name in (*BWD_KERNELS, *KNN_KERNELS.values()):
    SOURCES[_name] = f"gmf_tpu_torch/ops/csrc/{_name.rsplit('_', 1)[0]}.cu"
for _name in VARIANT_KERNELS.values():  # one source, four instances
    SOURCES[_name] = "gmf_tpu_torch/ops/csrc/compat_flash_variants.cu"
REPLACES = {
    "compat_flash_attention": "gmf_tpu/ops/fused_attention.py:241",
    "build_compat_cache": "gmf_tpu/ops/fused_attention.py:625",
    "compat_flash_attention_build": "gmf_tpu/ops/fused_attention.py:766",
    "compat_flash_attention_cached": "gmf_tpu/ops/fused_attention.py:847",
    "nms_local_max": "gmf_tpu/ops/fused_nms.py:69",
    **{name: "gmf_tpu/ops/fused_topk.py:108"
       for name in KNN_KERNELS.values()},
    "seed_hypothesis_counts": "gmf_tpu/ops/fused_scoring.py:138",
    "fused_seed_weights": "gmf_tpu/ops/fused_seed_solver.py:163",
    "compat_flash_attention_bwd_dkv": "gmf_tpu/ops/fused_attention.py:310",
    "compat_flash_attention_bwd_dq": "gmf_tpu/ops/fused_attention.py:328",
    "compat_flash_attention_cached_bwd_dkv":
        "gmf_tpu/ops/fused_attention.py:982",
    "compat_flash_attention_cached_bwd_dq":
        "gmf_tpu/ops/fused_attention.py:1009",
    **{name: "scripts/bench_flash_variants.py:183"
       for name in VARIANT_KERNELS.values()},
}
# kernels that also stand for a pallas_call of the variant microbenchmark
ALSO_REPLACES = {
    "compat_flash_attention": "scripts/bench_flash_variants.py:183 (v2)",
    "compat_flash_attention_cached":
        "scripts/bench_flash_variants.py:183 (v4, v5)",
    "build_compat_cache": "scripts/bench_flash_variants.py:214",
}
# the served models run bf16 modules, so the kNN gets bf16 features
_COMMON = {"nms_local_max": 1, KNN_KERNELS[torch.bfloat16]: 1,
           "seed_hypothesis_counts": 1}
# the served paths: model modes, pairs per request, and the launches each
# forward must make (kernels not named: none)
PATHS = {
    "int8_b64": dict(compat_cache="int8", seed_solver="auto", pairs=B_MAIN,
                     per_forward={"compat_flash_attention_build": 1,
                                  "compat_flash_attention_cached": 11,
                                  **_COMMON}),
    "auto_b8": dict(compat_cache="auto", seed_solver="auto", pairs=B,
                    per_forward={"build_compat_cache": 1,
                                 "compat_flash_attention_cached": 12,
                                 **_COMMON}),
    "off_b8": dict(compat_cache="off", seed_solver="auto", pairs=B,
                   per_forward={"compat_flash_attention": 12, **_COMMON}),
    "int8_fused_b8": dict(compat_cache="int8", seed_solver="fused", pairs=B,
                          per_forward={"compat_flash_attention_build": 1,
                                       "compat_flash_attention_cached": 11,
                                       "fused_seed_weights": 1, **_COMMON}),
    "int8_b8": dict(compat_cache="int8", seed_solver="xla", pairs=B,
                    per_forward={"compat_flash_attention_build": 1,
                                 "compat_flash_attention_cached": 11,
                                 **_COMMON}),
    # the reference's dense path: the [B, N, N] compat and dense attention
    # (no attention kernel), dense NMS; the kNN and counts kernels
    "dense_b8": dict(compat_cache="auto", seed_solver="auto", pairs=B,
                     fused_attention=False,
                     per_forward={KNN_KERNELS[torch.bfloat16]: 1,
                                  "seed_hypothesis_counts": 1}),
}
# the raw-descriptor path (raw_path): requests of RAW_PAIRS pairs drawn
# from RAW_FRAGMENTS fragments of RAW_POINTS keypoints with RAW_DESC-d unit
# descriptors, matched on the card, through a DeviceFragmentCache, with the
# int8 cache and bf16 modules: the serving main path's launches a forward
RAW_PAIRS, RAW_REQUESTS, RAW_FRAGMENTS, RAW_POINTS, RAW_DESC = 16, 2, 8, \
    N, 32
RAW_SCENE = 6000  # the scene points the fragments are drawn from
RAW_PER_FORWARD = PATHS["int8_b64"]["per_forward"]
# training (the reference's 3DMatch configuration at full width, f32):
# pairs per step, correspondences per pair, the image size
B_TRAIN, N_TRAIN = 16, 1000
S_TRAIN = N_TRAIN // 10  # seeds per pair at ratio 0.1
_TRAIN_COMMON = {KNN_KERNELS[torch.float32]: 1, "seed_hypothesis_counts": 1}
_CACHED_STEP = {"build_compat_cache": 1, "compat_flash_attention_cached": 12,
                "compat_flash_attention_cached_bwd_dkv": 12,
                "compat_flash_attention_cached_bwd_dq": 12, **_TRAIN_COMMON}
# the training paths: model mode, steps (the first two of the main path
# are warm-up) and the launches each step must make
TRAIN_PATHS = {
    "train_auto": dict(compat_cache="auto", steps=5, cache=torch.float32,
                       per_step=_CACHED_STEP),
    "train_off": dict(compat_cache="off", steps=2, cache=None,
                      per_step={"compat_flash_attention": 12,
                                "compat_flash_attention_bwd_dkv": 12,
                                "compat_flash_attention_bwd_dq": 12,
                                **_TRAIN_COMMON}),
    "train_int8": dict(compat_cache="int8", steps=2, cache=torch.int8,
                       per_step=_CACHED_STEP),
    # the reference's default training: dense attention, no attention
    # kernel, the f32 kNN and the counts kernels
    "train_dense": dict(compat_cache="auto", fused_attention=False, steps=5,
                        cache=None, per_step=_TRAIN_COMMON),
}
# the path whose run gives each kernel's launch count in the result
KERNEL_PATH = {
    "compat_flash_attention": "off_b8",
    "build_compat_cache": "auto_b8",
    "compat_flash_attention_build": "int8_b64",
    "compat_flash_attention_cached": "int8_b64",
    "nms_local_max": "int8_b64",
    KNN_KERNELS[torch.bfloat16]: "int8_b64",
    KNN_KERNELS[torch.float32]: "train_auto",
    "seed_hypothesis_counts": "int8_b64",
    "fused_seed_weights": "int8_fused_b8",
    "compat_flash_attention_bwd_dkv": "train_off",
    "compat_flash_attention_bwd_dq": "train_off",
    "compat_flash_attention_cached_bwd_dkv": "train_auto",
    "compat_flash_attention_cached_bwd_dq": "train_auto",
    **{name: "bench_flash_variants" for name in VARIANT_KERNELS.values()},
}
# the attention-variant microbenchmark (gmf_tpu_torch.tools.
# bench_flash_variants) at its defaults but for the timed runs: one warm
# and VARIANT_ITERS timed stacks of VARIANT_LAYERS layers per variant
VARIANT_ITERS, VARIANT_LAYERS = 3, 12
VARIANT_RUNS = 1 + VARIANT_ITERS
# the launches of that run, per kernel (not named: none): 12 per stack of
# each variant's kernel (v2 the streaming one, v4 and v5 the cached one),
# one more of v1 (its single layer beside the library's), and, for v4 and
# v5, one cache per run of the precompute
VARIANT_BENCH_LAUNCHES = {
    **{name: VARIANT_LAYERS * VARIANT_RUNS + (v == "v1")
       for v, name in VARIANT_KERNELS.items()},
    "compat_flash_attention": VARIANT_LAYERS * VARIANT_RUNS,
    "compat_flash_attention_cached": 2 * VARIANT_LAYERS * VARIANT_RUNS,
    "build_compat_cache": 2 * VARIANT_RUNS,
}
# f32 ALU and SFU operations per (i, j) of each variant beside its two
# products: the compat arithmetic, the logit's multiply and mask, and the
# softmax's exp2; a sqrt or an IEEE division is one SFU operation
VARIANT_OPS = {
    "v0": (24, 4),  # 2 norm-identity dots 10, 2 x (add, 2x, sub, max),
                    # dd, dd^2, 1-, max, logit 2; 2 sqrt, div, exp2
    "v1": (1, 1),   # mask; exp2
    "v2": (20, 3),  # as kernel 1 (attention_bound)
    "v3": (25, 3),  # 6 sub, 6 mul, 4 add, one-sqrt 5, 1-, max, logit 2;
                    # sqrt, div, exp2
    "v4": (3, 1),   # as kernel 6: widen, multiply, mask; exp2
    "v5": (3, 1),
    "v6": (27, 3),  # norm identity 18, one-sqrt 5, 1-, max, logit 2;
                    # sqrt, div, exp2
}

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, dense bf16 tensor-core
# FLOP/s, f32 FLOP/s outside the tensor cores (an FMA is 2 FLOP).
HBM_BPS = 3.35e12
BF16_TC_FLOPS = 989e12
F32_FLOPS = 67e12
# An f32-accurate product's rate: the faster of the CUDA cores' f32 FMAs
# and the bf16 tensor cores running six products of a three-term bf16
# split, the route of the f32 forward and cached backward attention
F32_PRODUCT_FLOPS = max(F32_FLOPS, BF16_TC_FLOPS / 6)
SFU_PER_CLK_PER_SM = 16   # Hopper: 4 SFU quads per SM
ALU_PER_CLK_PER_SM = 128  # f32 lanes per SM


def product_rate(dtype) -> float:
    """FLOP/s of a matrix product whose operands are ``dtype``: bf16 on
    the tensor cores, f32 at f32 accuracy by the faster route."""
    return BF16_TC_FLOPS if dtype == torch.bfloat16 else F32_PRODUCT_FLOPS


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


def attention_bound(rates, dtype, cache_dtype=None, build=False, b=B, n=N):
    """(bound_ms, bound_by) of one attention call at [b, n, D].

    Bytes: q, k, v, out and the mask, plus the keypoints where compat is
    computed and the cache where one is read or written. Operations per
    (i, j): the two products (4 D flop); compat: ~20 ALU ops and 2 sqrt
    when streamed, ~29 ALU ops, 1 sqrt and 1 division when the int8 code is
    built and dequantized, 3 ALU ops (dequantize, multiply, mask) when a
    cache is read; one exp2 everywhere."""
    from gmf_tpu_torch.ops.fused_attention import cache_row_stride

    pairs = b * n * n
    esize = torch.finfo(dtype).bits // 8
    nbytes = 4 * b * n * D * esize + b * n * 4
    if cache_dtype is None or build:
        nbytes += b * n * 6 * 4
    if build:
        cache_dtype = torch.int8
    if cache_dtype is not None:
        nbytes += (b * n * cache_row_stride(n, cache_dtype)
                   * torch.empty((), dtype=cache_dtype).element_size())
    alu, sfu = (29, 3) if build else (20, 3) if cache_dtype is None else (3, 1)
    return rates.bound(nbytes, {
        "products": 4 * D * pairs / product_rate(dtype),
        "compat_alu": alu * pairs / rates.alu,
        "sfu": sfu * pairs / rates.sfu,
    })


def cache_bound(rates, cdt, b=B, n=N):
    """Bounds of the standalone cache of ``cdt`` at [b, n]: the keypoints
    read, the cache written; per (i, j) 20 ALU and 3 SFU ops (two-sqrt
    form, f32 and bf16) or 26 and 2 (one-sqrt int8 code). The cache is
    symmetric, so its work is the b n (n + 1) / 2 unordered pairs:
    {bound_ms, bound_by} over those, and the bound over all b n^2 entries
    beside it ({bound_all_entries_ms, bound_all_entries_by})."""
    from gmf_tpu_torch.ops.fused_attention import cache_row_stride

    two_sqrt = cdt != torch.int8
    esize = torch.empty((), dtype=cdt).element_size()
    nbytes = b * n * cache_row_stride(n, cdt) * esize + b * n * 6 * 4
    alu, sfu = (20, 3) if two_sqrt else (26, 2)
    out = {}
    for tag, entries in (("", b * n * (n + 1) / 2),
                         ("_all_entries", b * n * n)):
        ms, by = rates.bound(nbytes, {"alu": alu * entries / rates.alu,
                                      "sfu": sfu * entries / rates.sfu})
        out.update({f"bound{tag}_ms": ms, f"bound{tag}_by": by})
    return out


def cache_checks(where, got, ref, rebuild):
    """The standalone cache ``got`` of [b, n] pairs against ``ref``, its
    plain version (None: the caller holds it), in every byte; equal to its
    transpose over [:n, :n] (the kernel computes each tile pair once and
    stores the tile and its transpose); pad columns 0; ``rebuild()`` (a
    second launch) the same bytes. Checked in slices of B pairs."""
    n = got.shape[1]
    for s0 in range(0, got.shape[0], B):
        c = got[s0:s0 + B]
        if ref is not None and not torch.equal(c, ref[s0:s0 + B]):
            diff = (c.float() - ref[s0:s0 + B].float()).abs()
            fail(f"build_compat_cache {where}: differs from its plain "
                 f"version on {(diff > 0).float().mean().item():.2e} of "
                 f"the entries, by at most {diff.max().item()}")
        if not torch.equal(c[:, :, :n], c[:, :, :n].transpose(1, 2)):
            fail(f"build_compat_cache {where}: not equal to its transpose")
    if got[:, :, n:].any():
        fail(f"build_compat_cache {where}: a pad column is not 0")
    again = rebuild()
    if not torch.equal(again, got):
        fail(f"build_compat_cache {where}: two launches differ")


def attention_tol(ref, dtype):
    """f32: the kernel and its plain version differ by summation order and
    the running max only. bf16: the plain version rounds q*scale and p as
    the kernel does, and both round the output to bf16, so an output may
    land on the neighbouring bf16 value: 2 ulps at the largest output hold
    that and the f32 differences beneath it."""
    ref_max = ref.float().abs().max().item()
    return (1e-5 if dtype == torch.float32 else 2 * bf16_ulp(ref_max)), ref_max


def attention_phase(dev, rates, gen, src, tgt, mask):
    """Kernels 1, 4, 5 and 6: streaming, standalone cache, build+attend,
    cached."""
    from gmf_tpu_torch.ops.fused_attention import (
        build_compat_cache, build_compat_cache_plain,
        compat_attention_cached_plain, compat_attention_plain,
        compat_flash_attention, compat_flash_attention_build)

    f32, bf16, i8 = torch.float32, torch.bfloat16, torch.int8
    names = {f32: "f32", bf16: "bf16", i8: "int8"}
    rows = {}

    # -- kernel 4: the standalone cache, every byte against plain -------
    caches, cache_row = {}, {}
    for cdt in (i8, bf16, f32):
        got = build_compat_cache(src, tgt, 0.10, cdt)
        cache_checks(f"{names[cdt]} at B={B}, N={N}", got,
                     build_compat_cache_plain(src, tgt, 0.10, cdt),
                     lambda: build_compat_cache(src, tgt, 0.10, cdt))
        caches[cdt] = got
        cache_row[cdt] = dict(
            ms=cuda_ms(lambda: build_compat_cache(src, tgt, 0.10, cdt),
                       reps=5),
            plain_ms=cuda_ms(lambda: build_compat_cache_plain(
                src, tgt, 0.10, cdt), reps=2, warmup=1),
            **cache_bound(rates, cdt))
        torch.cuda.empty_cache()
    rows["build_compat_cache"] = dict(
        dtype="f32", max_abs_err=0.0, tolerance=0.0, **cache_row[f32],
        **{f"{names[c]}_{k}": v for c in (bf16, i8)
           for k, v in cache_row[c].items()},
        int8_share_above_minus127=(caches[i8][:, :, :N] > -127).float()
        .mean().item(),
        symmetric_pads_zero_two_launches_equal=True)

    # -- kernels 1, 5, 6 in f32 and bf16 ------------------------------------
    att = {name: {} for name in ("compat_flash_attention",
                                 "compat_flash_attention_build",
                                 "compat_flash_attention_cached")}
    for dtype in (f32, bf16):
        q, k, v = (torch.randn(B, N, D, generator=gen, device=dev).to(dtype)
                   for _ in range(3))

        def check(name, got, ref):
            tol, ref_max = attention_tol(ref, dtype)
            err = (got.float() - ref.float()).abs().max().item()
            if not err <= tol:
                fail(f"{name} {names[dtype]}: max abs err {err} > {tol}")
            return dict(max_abs_err=err, tol=tol, ref_max=ref_max)

        # kernel 1, streaming
        r = check("compat_flash_attention",
                  compat_flash_attention(q, k, v, src, tgt, mask=mask),
                  compat_attention_plain(q, k, v, src, tgt, mask=mask))
        r["ms"] = cuda_ms(lambda: compat_flash_attention(
            q, k, v, src, tgt, mask=mask), reps=5)
        r["plain_ms"] = cuda_ms(lambda: compat_attention_plain(
            q, k, v, src, tgt, mask=mask), reps=2, warmup=1)
        r["bound_ms"], r["bound_by"] = attention_bound(rates, dtype)
        att["compat_flash_attention"][dtype] = r

        # kernel 5, build+attend: the cache in every byte, the output
        out5, cache5 = compat_flash_attention_build(q, k, v, src, tgt,
                                                    mask=mask)
        if not torch.equal(cache5, caches[i8]):
            fail("compat_flash_attention_build: its int8 cache differs from "
                 "build_compat_cache's")
        ref_i8 = compat_attention_cached_plain(q, k, v, caches[i8],
                                               mask=mask)
        r = check("compat_flash_attention_build", out5, ref_i8)
        del cache5
        r["ms"] = cuda_ms(lambda: compat_flash_attention_build(
            q, k, v, src, tgt, mask=mask), reps=5)
        r["plain_ms"] = cuda_ms(lambda: compat_attention_cached_plain(
            q, k, v, build_compat_cache_plain(src, tgt, 0.10, i8),
            mask=mask), reps=2, warmup=1)
        r["bound_ms"], r["bound_by"] = attention_bound(rates, dtype,
                                                       build=True)
        att["compat_flash_attention_build"][dtype] = r

        # kernel 6, cached, on each cache type
        per_cache = {}
        for cdt in (i8, bf16, f32):
            got = compat_flash_attention(q, k, v, None, None, mask=mask,
                                         compat=caches[cdt])
            if cdt == i8 and not torch.equal(got, out5):
                fail("compat_flash_attention_cached: differs from the "
                     "build+attend output on the int8 cache")
            ref = ref_i8 if cdt == i8 else compat_attention_cached_plain(
                q, k, v, caches[cdt], mask=mask)
            r = check(f"compat_flash_attention_cached[{names[cdt]} cache]",
                      got, ref)
            r["ms"] = cuda_ms(lambda: compat_flash_attention(
                q, k, v, None, None, mask=mask, compat=caches[cdt]), reps=5)
            r["bound_ms"], r["bound_by"] = attention_bound(rates, dtype, cdt)
            if cdt == i8:
                r["plain_ms"] = cuda_ms(
                    lambda: compat_attention_cached_plain(
                        q, k, v, caches[i8], mask=mask), reps=2, warmup=1)
            per_cache[cdt] = r
            del got, ref
        att["compat_flash_attention_cached"][dtype] = per_cache
        del q, k, v, out5, ref_i8
        torch.cuda.empty_cache()

    main = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")
    for name in ("compat_flash_attention", "compat_flash_attention_build"):
        b, f = att[name][bf16], att[name][f32]
        rows[name] = dict(
            dtype="bf16", **{k: b[k] for k in main}, tolerance=b["tol"],
            max_abs_ref=b["ref_max"], f32_max_abs_err=f["max_abs_err"],
            f32_ms=f["ms"], f32_plain_ms=f["plain_ms"],
            f32_bound_ms=f["bound_ms"], f32_tolerance=f["tol"])
    c = att["compat_flash_attention_cached"]
    rows["compat_flash_attention_cached"] = dict(
        dtype="bf16", cache="int8", **{k: c[bf16][i8][k] for k in main},
        tolerance=c[bf16][i8]["tol"], max_abs_ref=c[bf16][i8]["ref_max"],
        equals_build_attend_output=True,
        **{f"{names[qd]}_{names[cd]}cache_{k}": c[qd][cd][k]
           for qd in (bf16, f32) for cd in (i8, bf16, f32)
           for k in ("max_abs_err", "ms", "bound_ms", "tol")
           if (qd, cd) != (bf16, i8)})
    return rows


def seed_solver_phase(rates, feats, src, tgt, knn_idx):
    """Kernel 12 on the neighbourhoods the kNN kernel chose, on features of
    the kNN's dtype (bf16: the served model's; f32): the weights within
    1e-5 of the plain version, the transforms from them within the
    reference's bounds, f32 also against the chain in f64
    (solver_f64_check); timed beside the plain version and the bound."""
    from gmf_tpu_torch.geometry.kabsch import rigid_transform_3d
    from gmf_tpu_torch.ops.fused_seed_solver import (
        fused_seed_weights, fused_seed_weights_plain)

    b, n, c = feats.shape
    s, k = knn_idx.shape[1], K1 - 1
    rows_idx = (knn_idx[..., 1:].long() + (
        torch.arange(b, device=feats.device) * n)[:, None, None]).reshape(-1)
    knn_feats = feats.reshape(b * n, c)[rows_idx].reshape(b, s, k, c)
    src_knn = src.reshape(b * n, 3)[rows_idx].reshape(b, s, k, 3)
    tgt_knn = tgt.reshape(b * n, 3)[rows_idx].reshape(b, s, k, 3)
    sigma = torch.tensor([SEED_SIGMA], device=feats.device)
    args = (knn_feats, src_knn, tgt_knn, sigma, 0.10)
    got = fused_seed_weights(*args, num_iters=NUM_ITERS)
    ref = fused_seed_weights_plain(*args, num_iters=NUM_ITERS)
    err = (got - ref).abs().max().item()
    # weights are ~1/k. The kernel rescales by the largest entry per round
    # where the plain version divides by the norm, and sums in another
    # order; the iteration amplifies that where the two leading
    # eigenvalues are close, so the transforms are compared too, with the
    # bounds of the reference's own test (eigenvector conditioning).
    where = f"fused_seed_weights ({feats.dtype}, B={b})"
    if not err <= 1e-5:
        fail(f"{where}: weights differ by {err} > 1e-5")
    extra = {} if feats.dtype != torch.float32 else dict(
        vs_f64=solver_f64_check(where, args, got, ref))

    def trans(w):
        return rigid_transform_3d(src_knn.reshape(-1, k, 3),
                                  tgt_knn.reshape(-1, k, 3),
                                  w.reshape(-1, k))

    Tg, Tr = trans(got), trans(ref)
    rot_err = (Tg[:, :3, :3] - Tr[:, :3, :3]).abs().max().item()
    trn_err = (Tg[:, :3, 3] - Tr[:, :3, 3]).abs().max().item()
    if not (rot_err <= 5e-4 and trn_err <= 5e-3):
        fail(f"{where}: transforms differ, rotation {rot_err} (> 5e-4) or "
             f"translation {trn_err} (> 5e-3)")
    del Tg, Tr
    seeds = b * s
    bound_ms, bound_by = rates.bound(
        seeds * k * (c * feats.element_size() + 24 + 4),
        {"gram": 2 * seeds * k * k * c / product_rate(feats.dtype),
         "alu": seeds * k * k * (25 + 2 * NUM_ITERS) / rates.alu,
         "sfu": 4 * seeds * k * k / rates.sfu})  # 2 sqrt, 2 divisions
    return dict(
        max_abs_err=err, tolerance=1e-5, rotation_err=rot_err,
        translation_err=trn_err, mean_weight=got.mean().item(),
        ms=cuda_ms(lambda: fused_seed_weights(*args, num_iters=NUM_ITERS),
                   reps=10),
        plain_ms=cuda_ms(lambda: fused_seed_weights_plain(
            *args, num_iters=NUM_ITERS), reps=3, warmup=1),
        bound_ms=bound_ms, bound_by=bound_by, **extra)


def solver_row(rows):
    """The seed solver's row from its two instances: the f32 one's keys
    (the instance this row has timed since the port began) and the bf16
    one's (the served model's features) prefixed ``bf16_``."""
    return {**rows[torch.float32],
            **{f"bf16_{k}": v for k, v in rows[torch.bfloat16].items()}}


def solver_f64_check(where, args, got, ref):
    """The f32 instance's weights and the plain version's against the
    chain in f64 on the same inputs (weights_from_gram on the f64 Gram and
    keypoints). The kernel must lie within twice the plain f32 version's
    distance. 1e-5 of the plain version does not tell the three-term split
    from its hi term alone; this does (the CPU model,
    tests/test_torch_ops.py::test_seed_solver_split_gram_keeps_f32_accuracy:
    the split 0.6-1.4x the plain distance, the hi term over 1000x)."""
    from gmf_tpu_torch.ops.fused_seed_solver import weights_from_gram

    feats, src_knn, tgt_knn, sigma, sigma_d = args
    f = feats.double()
    exact = weights_from_gram(f @ f.transpose(-1, -2), src_knn.double(),
                              tgt_knn.double(), sigma, sigma_d,
                              num_iters=NUM_ITERS)
    del f
    kernel = (got.double() - exact).abs().max().item()
    plain = (ref.double() - exact).abs().max().item()
    if not kernel <= 2 * plain:
        fail(f"{where}: weights {kernel} from the f64 chain, more than "
             f"twice the plain f32 version's {plain}")
    return dict(kernel=kernel, plain=plain, limit=2 * plain)


def perturbed_hypotheses(gt_trans, dev, s=S):
    """[batch, s, 4, 4] hypotheses: each pair's true transform turned by
    ~0.02 rad about x and z and shifted by ~2 cm, so the inlier counts
    spread."""
    rng = np.random.RandomState(SEED + 1)
    batch = gt_trans.shape[0]
    a = 0.02 * rng.randn(batch, s, 3)
    c, sn = np.cos(a), np.sin(a)
    Rx = np.tile(np.eye(3), (batch, s, 1, 1))
    Rz = Rx.copy()
    Rx[..., 1, 1], Rx[..., 1, 2] = c[..., 0], -sn[..., 0]
    Rx[..., 2, 1], Rx[..., 2, 2] = sn[..., 0], c[..., 0]
    Rz[..., 0, 0], Rz[..., 0, 1] = c[..., 2], -sn[..., 2]
    Rz[..., 1, 0], Rz[..., 1, 1] = sn[..., 2], c[..., 2]
    T = np.repeat(gt_trans[:, None], s, axis=1).copy()
    T[..., :3, :3] = (Rx @ Rz) @ T[..., :3, :3]
    T[..., :3, 3] += 0.02 * rng.randn(batch, s, 3)
    return torch.tensor(T.astype(np.float32), device=dev)


def knn_score_err(seeds, feats, mask, got_i, ref_v):
    """Largest gap between the scores of the neighbours the kernel chose
    and the plain version's. Near-ties (score gaps below f32
    summation-order error) may swap neighbours between the two; the
    chosen scores must agree."""
    full = torch.matmul(seeds.float(), feats.float().transpose(-1, -2))
    full = torch.where(mask[:, None] > 0, full,
                       torch.full_like(full, -math.inf))
    return (full.gather(-1, got_i.long()) - ref_v).abs().max().item()


def knn_inputs(gen, mask, s, dtype):
    """(seeds, feats): unit features of depth D rounded to ``dtype``, and
    ``s`` seeds per pair among the rows every pair holds valid."""
    batch, n = mask.shape
    feats = torch.randn(batch, n, D, generator=gen, device=mask.device)
    feats = (feats / feats.norm(dim=-1, keepdim=True)).to(dtype)
    seed_idx = torch.randperm(int(mask.sum(-1).min()), generator=gen,
                              device=mask.device)[:s]
    return feats[:, seed_idx].contiguous(), feats


def knn_bound(rates, dtype, b, s, n):
    """(bound_ms, bound_by) of one seed kNN: seeds and keys of ``dtype``
    and the mask read once, k + 1 indices and scores written; the
    products at ``product_rate``, and one compare per score."""
    size = torch.tensor([], dtype=dtype).element_size()
    return rates.bound((b * s + b * n) * D * size + b * n * 4
                       + b * s * K1 * 8,
                       {"products": 2 * b * s * n * D / product_rate(dtype),
                        "select": b * s * n / rates.alu})


def knn_check(where, seeds, feats, mask, slices, rates):
    """The kNN instance of the features' dtype against its plain version,
    fed the same values, on each slice of pairs: the chosen scores within
    1e-5. Returns the kernel's indices and its row: the error, the share
    of indices equal to the plain version's, the ms of the kernel and of
    the plain version over all pairs, and the bound."""
    from gmf_tpu_torch.ops.fused_topk import (seed_knn_topk,
                                              seed_knn_topk_plain)

    got_i, _ = seed_knn_topk(seeds, feats, K1, mask=mask)
    err, same = 0.0, 0
    for sl in slices:
        ref_i, ref_v = seed_knn_topk_plain(seeds[sl], feats[sl], K1,
                                           mask=mask[sl])
        err = max(err, knn_score_err(seeds[sl], feats[sl], mask[sl],
                                     got_i[sl], ref_v))
        same += int((got_i[sl] == ref_i).sum().item())
        del ref_i, ref_v
    name = KNN_KERNELS[feats.dtype]
    if not err <= 1e-5:
        fail(f"{where}: {name}: chosen scores differ by {err}")
    b, s, n = seeds.shape[0], seeds.shape[1], feats.shape[1]
    row = dict(
        max_abs_err=err, tolerance=1e-5,
        index_agreement=same / got_i.numel(),
        ms=cuda_ms(lambda: seed_knn_topk(seeds, feats, K1, mask=mask),
                   reps=10),
        plain_ms=cuda_ms(lambda: seed_knn_topk_plain(seeds, feats, K1,
                                                     mask=mask),
                         reps=3, warmup=1),
        **dict(zip(("bound_ms", "bound_by"),
                   knn_bound(rates, feats.dtype, b, s, n))))
    return got_i, row


def nms_check(where, src, scores, slices, rates):
    """NMS at radius 0.10 against its plain version run on each slice of
    pairs: equal in every bit. Returns its row: the times of the kernel's
    call, of its sort and its scan alone, and of the plain version over
    all pairs, and the bound of the work NMS needs: ~10 ALU ops per (i, j)
    compared, a local maximum compared with every key within the radius
    (the plain version's d2 < R^2), every other row with one key (its
    first suppressor); 20 bytes a point (the point and its score read, the
    flag written). Beside it, as the sweep's own work: the pairs it
    compares at least (a local maximum against every key within the radius
    in x, ``sweep_pairs``) and their bound, and the bound of a kernel whose
    local maxima compare with every key (PRs 1-8's bound)."""
    from gmf_tpu_torch.ops import _build
    from gmf_tpu_torch.ops.fused_nms import (nms_local_max,
                                             nms_local_max_plain)

    got = nms_local_max(src, scores, 0.10)
    ref = torch.cat([nms_local_max_plain(src[sl], scores[sl], 0.10)
                     for sl in slices])
    err = (got - ref).abs().max().item()
    if err != 0:
        fail(f"{where}: nms_local_max disagrees with its plain version "
             f"({err})")
    b, n, _ = src.shape
    n_max = int(ref.sum().item())
    # keys within the radius of each local maximum, as the plain version
    # measures it
    near = 0
    for sl in slices:
        s = src[sl]
        d = [s[:, :, None, c] - s[:, None, :, c] for c in range(3)]
        d2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        near += int(((d2 < 0.10 ** 2).sum(-1) * ref[sl]).sum().item())
        del d, d2
    # keys within the radius in x of each row
    x = src[..., 0].contiguous()
    xs = torch.sort(x, dim=1).values
    slab = (torch.searchsorted(xs, x + 0.10)
            - torch.searchsorted(xs, x - 0.10, right=True))
    needed = near + (b * n - n_max)
    sweep = int(slab[ref > 0].sum().item()) + (b * n - n_max)
    all_keys = n_max * n + (b * n - n_max)
    del xs, slab
    lib, stream = _build.load(), _build.stream_of(src)
    kp, sc = src.float().contiguous(), scores.float().contiguous()
    keys = torch.empty(b, n, 4, device=src.device)
    order = torch.empty(b, n, dtype=torch.int32, device=src.device)
    out = torch.empty(b, n, device=src.device)

    def sort():
        return lib.gmf_nms_sort(kp.data_ptr(), sc.data_ptr(),
                                keys.data_ptr(), order.data_ptr(), b, n,
                                stream)

    def scan():
        return lib.gmf_nms_scan(keys.data_ptr(), order.data_ptr(),
                                out.data_ptr(), b, n, 0.10 ** 2, stream)

    if sort() != 0 or scan() != 0 or not torch.equal(out, ref):
        fail(f"{where}: nms sort and scan called alone disagree with the "
             "plain version")
    return dict(
        max_abs_err=err, tolerance=0.0, shape=[b, n],
        ms=cuda_ms(lambda: nms_local_max(src, scores, 0.10), reps=10),
        sort_ms=cuda_ms(sort, reps=10), scan_ms=cuda_ms(scan, reps=10),
        plain_ms=cuda_ms(lambda: [nms_local_max_plain(
            src[sl], scores[sl], 0.10) for sl in slices], reps=3, warmup=1),
        local_maxima=n_max, pairs_needed=needed,
        sweep_pairs=sweep, bound_sweep_ms=rates.bound(
            b * n * 20, {"alu": 10 * sweep / rates.alu})[0],
        bound_all_keys_ms=rates.bound(
            b * n * 20, {"alu": 10 * all_keys / rates.alu})[0],
        **dict(zip(("bound_ms", "bound_by"), rates.bound(
            b * n * 20, {"alu": 10 * needed / rates.alu}))))


def counts_check(where, rates, trans, src, tgt, mask, slices):
    """The hypothesis counts against their plain version run on each slice
    of pairs: equal in every count, as the two form the residual with the
    same rounded operations in the same order, and a second launch equal
    to the first. Returns the row: the times of the kernel and of the
    plain version over all pairs, and the function's own bound, ~16 ALU
    ops per (seed, point) with fused multiply-adds (the kernel's
    exact-rounding form issues ~28), the transforms, the points and the
    mask read once, the counts written."""
    from gmf_tpu_torch.ops.fused_scoring import (
        seed_hypothesis_counts, seed_hypothesis_counts_plain)

    got = seed_hypothesis_counts(trans, src, tgt, 0.10, mask=mask)
    ref = torch.cat([seed_hypothesis_counts_plain(
        trans[sl], src[sl], tgt[sl], 0.10, mask=mask[sl]) for sl in slices])
    err = (got - ref).abs().max().item()
    if err != 0:
        fail(f"{where}: seed_hypothesis_counts: counts differ by {err}")
    if not torch.equal(seed_hypothesis_counts(trans, src, tgt, 0.10,
                                              mask=mask), got):
        fail(f"{where}: seed_hypothesis_counts: two launches differ")
    b, s = trans.shape[:2]
    n = src.shape[1]
    return dict(
        max_abs_err=err, tolerance=0, shape=[b, s, n],
        mean_count=got.float().mean().item(),
        ms=cuda_ms(lambda: seed_hypothesis_counts(trans, src, tgt, 0.10,
                                                  mask=mask), reps=10),
        plain_ms=cuda_ms(lambda: [seed_hypothesis_counts_plain(
            trans[sl], src[sl], tgt[sl], 0.10, mask=mask[sl])
            for sl in slices], reps=3, warmup=1),
        **dict(zip(("bound_ms", "bound_by"), rates.bound(
            b * s * 64 + b * n * 28 + b * s * 4,
            {"alu": 16 * b * s * n / rates.alu}))))


def kernel_phase(dev, rates):
    """Phase 3: every kernel vs its plain version at main-path shapes."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    prob, src, tgt, mask = make_inputs(dev)
    rows = attention_phase(dev, rates, gen, src, tgt, mask)

    # -- NMS -------------------------------------------------------------
    scores = torch.randn(B, N, generator=gen, device=dev)
    rows["nms_local_max"] = nms_check(f"B={B}", src, scores, [slice(None)],
                                      rates)

    # -- seed kNN, both instances, and the seed solver on each one's
    # features and the neighbourhoods it chose ----------------------------
    solver = {}
    for dtype in (torch.bfloat16, torch.float32):
        seeds, feats = knn_inputs(gen, mask, S, dtype)
        got_i, rows[KNN_KERNELS[dtype]] = knn_check(
            f"B={B}", seeds, feats, mask, [slice(None)], rates)
        solver[dtype] = seed_solver_phase(rates, feats, src, tgt, got_i)
        del feats, seeds, got_i
    rows["fused_seed_weights"] = solver_row(solver)

    # -- hypothesis scoring ------------------------------------------------
    trans = perturbed_hypotheses(prob["gt_trans"], dev)
    rows["seed_hypothesis_counts"] = counts_check(
        f"B={B}", rates, trans, src, tgt, mask, [slice(None)])
    return rows


def main_shape_phase(dev, rates):
    """Phase 3, second part: the main path's five kernels at the shapes
    that path gives them, B_MAIN pairs in one launch, attention in bf16,
    every pair with its own count of valid rows. The pairs are independent,
    so the plain versions run in slices of B pairs and their [B, N, N]
    temporaries stay as large as in the first part. Same limits as there;
    the kNN in both instances (its main path takes bf16), each also timed
    over all B_MAIN pairs beside its plain version; NMS timed beside its
    plain version and its work-based bound. Returns each kernel's largest
    error, the two kNN rows (knn_check) and NMS's row (nms_check)."""
    from gmf_tpu_torch.data.synthetic import make_correspondence_problem
    from gmf_tpu_torch.ops.fused_attention import (
        build_compat_cache_plain, compat_attention_cached_plain,
        compat_flash_attention, compat_flash_attention_build)

    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    prob = make_correspondence_problem(np.random.RandomState(SEED + 2),
                                       num_corr=N, inlier_ratio=0.4,
                                       image_hw=(8, 8), batch=B_MAIN)
    src = torch.tensor(prob["src_keypts"], device=dev)
    tgt = torch.tensor(prob["tgt_keypts"], device=dev)
    valid = N - (torch.arange(B_MAIN, device=dev) * 37) % 1000
    mask = (torch.arange(N, device=dev)[None] < valid[:, None]).float()
    slices = [slice(s0, s0 + B) for s0 in range(0, B_MAIN, B)]
    errs = {}

    # build+attend and cached: every byte of the cache, the two outputs
    # equal, the output against the plain version
    q, k, v = (torch.randn(B_MAIN, N, D, generator=gen, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    out5, cache5 = compat_flash_attention_build(q, k, v, src, tgt, mask=mask)
    out6 = compat_flash_attention(q, k, v, None, None, mask=mask,
                                  compat=cache5)
    if not torch.equal(out6, out5):
        fail(f"B={B_MAIN}: compat_flash_attention_cached differs from the "
             "build+attend output on the int8 cache")
    worst = 0.0
    for sl in slices:
        where = f"B={B_MAIN}, pairs {sl.start}..{sl.stop - 1}"
        ref_cache = build_compat_cache_plain(src[sl], tgt[sl], 0.10,
                                             torch.int8)
        if not torch.equal(cache5[sl], ref_cache):
            fail(f"{where}: the build+attend int8 cache differs from the "
                 "plain version's")
        ref = compat_attention_cached_plain(q[sl], k[sl], v[sl], ref_cache,
                                            mask=mask[sl])
        tol, _ = attention_tol(ref, torch.bfloat16)
        err = (out5[sl].float() - ref.float()).abs().max().item()
        if not err <= tol:
            fail(f"{where}: compat_flash_attention_build max abs err "
                 f"{err} > {tol}")
        worst = max(worst, err)
        del ref_cache, ref
    errs["compat_flash_attention_build"] = worst
    errs["compat_flash_attention_cached"] = worst
    del q, k, v, out5, out6, cache5
    torch.cuda.empty_cache()

    scores = torch.randn(B_MAIN, N, generator=gen, device=dev)
    nms_row = nms_check(f"B={B_MAIN}", src, scores, slices, rates)
    errs["nms_local_max"] = nms_row["max_abs_err"]
    print(f"nms_local_max at B={B_MAIN}: {json.dumps(nms_row)}", flush=True)

    seed_errs, seed_rows = seed_kernels_check(
        f"B={B_MAIN}", gen, prob["gt_trans"], src, tgt, mask, S, slices,
        rates, solver=True)
    errs.update(seed_errs)
    return errs, seed_rows, nms_row


# the bf16 forward core (compat_flash_fwd_tc) at the edges of its tiles:
# key counts below, at and around one 64-key tile (the tile beside a bf16
# or f32 cache) and one 128-key tile and 128-row query block, a ragged 333
# and the bench's 5000, at both head widths, in each of its modes
CORE_N = (1, 63, 64, 65, 127, 128, 129, 333, 5000)
CORE_D = (32, 128)
CORE_MODES = ("stream", "build", "cached_int8", "cached_bf16", "cached_f32",
              "none")
# the f32 core (compat_flash_fwd_split): key counts around its 32-key
# slots and 64-query blocks, a ragged 333 and the training shape's 1000;
# its modes and the variants' other instances (v0, v3, v6)
F32_CORE_N = (1, 31, 32, 33, 64, 65, 333, 1000)
F32_CORE_MODES = CORE_MODES + ("v0", "v3", "v6")
CACHE_OF = {"cached_int8": torch.int8, "cached_bf16": torch.bfloat16,
            "cached_f32": torch.float32}


def core_inputs(gen, b, n, d, dev, dtype=torch.bfloat16):
    """q, k, v [b, n, d] of ``dtype``, keypoints in a 2.5 m cube with 40%
    of the targets near their sources, and the mask: pair 0 with masked
    keys in the middle of its tiles (keys 20..39 of every 64 and every key
    of index 3 mod 7), pair 1 with every key masked, the others none."""
    q, k, v = (torch.randn(b, n, d, generator=gen, device=dev).to(dtype)
               for _ in range(3))
    src = 2.5 * torch.rand(b, n, 3, generator=gen, device=dev)
    tgt = torch.where(torch.rand(b, n, 1, generator=gen, device=dev) < 0.4,
                      src + 0.02 * torch.randn(b, n, 3, generator=gen,
                                               device=dev),
                      2.5 * torch.rand(b, n, 3, generator=gen, device=dev))
    mask = torch.ones(b, n, device=dev)
    j = torch.arange(n, device=dev)
    mask[0, ((j % 64 >= 20) & (j % 64 < 40)) | (j % 7 == 3)] = 0.0
    if b > 1:
        mask[1] = 0.0
    return q, k, v, src, tgt, mask


def core_run(mode, q, k, v, src, tgt, mask):
    """One launch of the forward core in ``mode``: (out, lse or None,
    the cache it built or read, or None). The cached modes build their
    cache first."""
    from gmf_tpu_torch.ops.flash_variants import flash_variant
    from gmf_tpu_torch.ops.fused_attention import (
        _cached_forward, _streaming_forward, build_compat_cache,
        compat_flash_attention_build)

    if mode == "stream":
        return (*_streaming_forward(q, k, v, src, tgt, mask, 0.10, True),
                None)
    if mode == "build":
        out, cache = compat_flash_attention_build(q, k, v, src, tgt,
                                                  mask=mask)
        return out, None, cache
    if mode in CACHE_OF:
        cache = build_compat_cache(src, tgt, 0.10, CACHE_OF[mode])
        return (*_cached_forward(q, k, v, cache, mask, True), cache)
    variant = "v1" if mode == "none" else mode
    return flash_variant(q, k, v, src, tgt, mask=mask, variant=variant), \
        None, None


def core_case(mode, q, k, v, src, tgt, mask, pairs=slice(None)):
    """One mode of the forward core on the card and its plain version on
    the pairs ``pairs``: ((out, lse), (ref_out, ref_lse)), lse None where
    the kernel writes none (build+attend, the variants). The build+attend
    cache must equal the plain one in every byte, and its output the
    cached kernel's on that cache exactly. In f32 a second launch must
    give the same bits."""
    from gmf_tpu_torch.ops.flash_variants import flash_variant_plain
    from gmf_tpu_torch.ops.fused_attention import (
        build_compat_cache_plain, compat_attention_cached_plain,
        compat_attention_plain, compat_flash_attention)

    p = pairs
    out, lse, cache = core_run(mode, q, k, v, src, tgt, mask)
    if q.dtype == torch.float32:
        again, again_lse, _ = core_run(mode, q, k, v, src, tgt, mask)
        if not (torch.equal(again[p], out[p]) and (
                lse is None or torch.equal(again_lse[p], lse[p]))):
            fail(f"core {mode} f32: two launches differ")
        del again, again_lse
    if mode == "stream":
        ref = compat_attention_plain(q[p], k[p], v[p], src[p], tgt[p],
                                     mask[p], return_lse=True)
    elif mode == "build":
        ref_cache = build_compat_cache_plain(src, tgt, 0.10, torch.int8)
        if not torch.equal(cache, ref_cache):
            fail(f"core {mode}: the int8 cache differs from the plain one")
        cached = compat_flash_attention(q, k, v, None, None, mask=mask,
                                        compat=cache)
        if not torch.equal(out[p], cached[p]):
            fail(f"core {mode}: the output differs from the cached "
                 "kernel's on the cache it built")
        ref = compat_attention_cached_plain(q[p], k[p], v[p], ref_cache[p],
                                            mask[p], return_lse=True)
    elif mode in CACHE_OF:
        ref = compat_attention_cached_plain(q[p], k[p], v[p], cache[p],
                                            mask[p], return_lse=True)
    else:
        variant = "v1" if mode == "none" else mode
        ref = flash_variant_plain(q[p], k[p], v[p], src[p], tgt[p],
                                  mask=mask[p], variant=variant), None
    return (out[p], None if lse is None else lse[p]), ref


def core_psum_err(where, mode, q, k, src, tgt, mask, lse):
    """f32: each row of a pair with a valid key recomputes p = exp2(s -
    lse) from the kernel's lse, as the backward does; the p of a row must
    sum to 1 within 1e-5. Returns the largest error."""
    from gmf_tpu_torch.ops.fused_attention import (
        _load_compat, _logits_plain, _stream_compat_plain,
        build_compat_cache)

    if mode == "stream":
        compat = _stream_compat_plain(src, tgt, 0.10)
    else:
        compat = _load_compat(build_compat_cache(src, tgt, 0.10,
                                                 CACHE_OF[mode]), q.shape[1])
    rows = (mask > 0).any(-1, keepdim=True).expand_as(mask)
    if not rows.any():
        return 0.0
    psum = torch.exp2(_logits_plain(q, k, compat, mask)
                      - lse[..., None]).sum(-1)
    err = (psum[rows] - 1.0).abs().max().item()
    if not err <= 1e-5:
        fail(f"{where}: p sums to 1 within {err} only")
    return err


def core_errors(where, got, ref, dtype=torch.bfloat16):
    """Output within attention_tol (2 bf16 ulps of the largest output,
    f32 1e-5), lse within 1e-5 (summation order) on every row of a pair
    with a valid key; returns (out err, lse err or None)."""
    (out, lse), (ref_out, ref_lse) = got, ref
    tol, _ = attention_tol(ref_out, dtype)
    err = (out.float() - ref_out.float()).abs().max().item()
    if not err <= tol:
        fail(f"{where}: max abs err {err} > {tol}")
    if lse is None:
        return err, None
    rows = ref_lse > -1e8  # pairs with every key masked: lse -1e9
    lse_err = (lse - ref_lse)[rows].abs().max().item() if rows.any() else 0.
    if not lse_err <= 1e-5:
        fail(f"{where}: lse differs from the plain forward's by {lse_err}")
    return err, lse_err


def max_measured(a, b):
    """The larger of two errors, either of which may be None (not
    measured: the kernel writes no lse); None if neither was measured."""
    return a if b is None else b if a is None else max(a, b)


def core_phase(dev, dtype=torch.bfloat16):
    """The forward core of ``dtype`` in each mode (streaming, build+attend,
    cached on int8, bf16 and f32 caches, no compat; in f32 also the
    variants v0, v3, v6) at D = 32 and 128 and every N of CORE_N (f32:
    F32_CORE_N), 3 pairs (core_inputs' masks), against its plain version
    (core_case, core_errors). Then the pair boundary at N = 333, whose
    last tile reaches into the next pair: 2 pairs, pair 1's k and v all
    inf and its mask 1; pair 0's output and lse against the plain version
    of pair 0 alone, with the same limits. f32 also: two launches equal in
    every bit, and p recomputed from the lse summing to 1 within 1e-5
    (core_psum_err). Returns each mode's largest errors; the lse error is
    None for the modes that write no lse (build, the variants)."""
    f32 = dtype == torch.float32
    modes = F32_CORE_MODES if f32 else CORE_MODES
    sizes = F32_CORE_N if f32 else CORE_N
    name = "f32" if f32 else "bf16"
    gen = torch.Generator(device=dev).manual_seed(SEED + (6 if f32 else 5))
    worst = {m: [0.0, None, None] for m in modes}

    def record(where, mode, inputs, pairs=slice(None)):
        got, ref = core_case(mode, *inputs, pairs)
        err, lse_err = core_errors(where, got, ref, dtype)
        w = worst[mode]
        w[0] = max(w[0], err)
        w[1] = max_measured(w[1], lse_err)
        if f32 and got[1] is not None:
            q, k, _, src, tgt, mask = inputs
            w[2] = max_measured(w[2], core_psum_err(
                where, mode, q[pairs], k[pairs], src[pairs], tgt[pairs],
                mask[pairs], got[1]))

    for d in CORE_D:
        for n in sizes:
            inputs = core_inputs(gen, 3, n, d, dev, dtype)
            for mode in modes:
                record(f"core {name} {mode} D={d} N={n}", mode, inputs)
            del inputs
        q, k, v, src, tgt, _ = core_inputs(gen, 2, 333, d, dev, dtype)
        k[1], v[1] = math.inf, math.inf
        mask = torch.ones(2, 333, device=dev)
        for mode in modes:
            record(f"core {name} {mode} D={d} pair boundary", mode,
                   (q, k, v, src, tgt, mask), slice(0, 1))
    torch.cuda.empty_cache()
    out = {m: {"max_abs_err": e, "lse_max_abs_err": le,
               **({"p_sum_err": pe} if f32 else {})}
           for m, (e, le, pe) in worst.items()}
    print(f"{name} core checks passed (N {list(sizes)}, D {list(CORE_D)}, "
          f"pair boundary{', two launches equal' if f32 else ''}): "
          f"{json.dumps(out)}", flush=True)
    return out


def seed_kernels_check(where, gen, gt_trans, src, tgt, mask, s, slices,
                       rates, solver=False):
    """The seed kNN, both instances, and the hypothesis counts at the
    shapes of one path: ``s`` seeds per pair among its valid rows, unit
    features of depth D, hypotheses near each pair's true transform; with
    ``solver`` also the seed solver on each kNN instance's features and
    neighbourhoods. The plain versions run on each slice of pairs;
    kernel_phase's limits. Returns each kernel's largest error and its row
    (knn_check, counts_check, solver_row), each timed."""
    errs, rows, solved = {}, {}, {}
    for dtype in (torch.bfloat16, torch.float32):
        seeds, feats = knn_inputs(gen, mask, s, dtype)
        got_i, row = knn_check(where, seeds, feats, mask, slices, rates)
        errs[KNN_KERNELS[dtype]] = row["max_abs_err"]
        rows[KNN_KERNELS[dtype]] = row
        if solver:
            solved[dtype] = seed_solver_phase(rates, feats, src, tgt, got_i)
        del seeds, feats, got_i
        torch.cuda.empty_cache()
    if solver:
        rows["fused_seed_weights"] = solver_row(solved)

    trans = perturbed_hypotheses(gt_trans, mask.device, s)
    rows["seed_hypothesis_counts"] = counts_check(where, rates, trans, src,
                                                  tgt, mask, slices)
    errs["seed_hypothesis_counts"] = rows["seed_hypothesis_counts"][
        "max_abs_err"]
    return errs, rows


def bwd_bound(rates, dtype, nbytes_side, alu, sfu, products, out_tensors,
              b=B_TRAIN, n=N_TRAIN):
    """(bound_ms, bound_by) of one backward kernel at [b, n, D]: q, k, v,
    do read and ``out_tensors`` outputs written in ``dtype``, lse, delta
    and mask, plus ``nbytes_side`` (keypoints or the cache); per (i, j)
    ``products`` products of depth D (2 D flop each), ``alu`` f32 ALU ops
    and ``sfu`` SFU ops."""
    pairs = b * n * n
    esize = torch.finfo(dtype).bits // 8
    nbytes = (4 + out_tensors) * b * n * D * esize + 3 * b * n * 4
    return rates.bound(nbytes + nbytes_side, {
        "products": 2 * D * products * pairs / product_rate(dtype),
        "alu": alu * pairs / rates.alu, "sfu": sfu * pairs / rates.sfu})


def bwd_tol(ref, dtype) -> float:
    """The backward kernels' limit against their plain version: f32 1e-5
    of the largest entry (the two sum in another order, the cached kernels
    through the three-term bf16 split); bf16 4 bf16 ulps of it (both round
    p and dlogits to bf16 before their products, and an operand at a
    rounding edge may take the neighbouring value, then the result is
    rounded to bf16)."""
    scale = ref.float().abs().max().item()
    return 1e-5 * scale if dtype == torch.float32 else 4 * bf16_ulp(scale)


# the CPU model of the f32 forward's schedule at the training shape
# (tests/test_torch_ops.py, test_f32_forward_schedule_keeps_f32_accuracy):
# distance from an f64 attention over the largest output
F32_FWD_MODEL = {"six_terms_tile_sums": 1.0e-6, "three_terms": 5.7e-6,
                 "straight_into_o": 1.2e-5, "plain_f32": 1.3e-6}


def f32_forward_f64_check(tag, q, k, v, compat, mask, out, ref_out):
    """The f32 forward and its plain version against the attention in f64
    on the same f32 inputs and compat, each over the largest output, on
    the valid query rows. The kernel must lie within twice the plain f32
    version's distance, f32's own error, as in the CPU model of its
    schedule (F32_FWD_MODEL), where three term products or P V straight
    into O lie outside it. 1e-5 of the plain version does not tell those
    apart; this does."""
    from gmf_tpu_torch.ops.fused_attention import _qscale

    qs = q.double() * _qscale(q.shape[-1])
    logits = compat.double() * (qs @ k.double().transpose(-1, -2))
    logits = torch.where(mask[:, None, :] > 0, logits,
                         torch.full_like(logits, -1e9))
    p = torch.exp2(logits - logits.amax(-1, keepdim=True))
    exact = (p @ v.double()) / p.sum(-1, keepdim=True)
    del logits, p
    valid = mask > 0
    scale = exact[valid].abs().max().item()
    kernel = (out.double() - exact)[valid].abs().max().item() / scale
    plain = (ref_out.double() - exact)[valid].abs().max().item() / scale
    rel_plain = (out - ref_out)[valid].abs().max().item() / scale
    if not kernel <= 2 * plain:
        fail(f"forward {tag}: {kernel} of the largest output from the f64 "
             f"attention, more than twice the plain f32 version's {plain}")
    return dict(kernel=kernel, plain=plain, limit=2 * plain,
                kernel_vs_plain=rel_plain, largest=scale,
                cpu_model=F32_FWD_MODEL)


# the backward kernels by (kernel, streaming): their names in the kernels line
BWD_KERNELS = {("dkv", True): "compat_flash_attention_bwd_dkv",
               ("dq", True): "compat_flash_attention_bwd_dq",
               ("dkv", False): "compat_flash_attention_cached_bwd_dkv",
               ("dq", False): "compat_flash_attention_cached_bwd_dq"}


def f32_backward_f64_check(tag, q, k, v, do, compat, mask, got, ref):
    """The f32 backward kernels and the plain f32 backward against the
    backward in f64 on the same f32 inputs and compat (out, lse and delta
    exact too; masked query rows carry no p, as in the kernels), each
    gradient over its largest entry. A kernel must lie within twice the
    plain f32 version's distance, f32's own error: 1e-5 of the plain
    version does not tell six term products from three. ``got``, ``ref``:
    (dq, dk, dv) of the kernels and of the plain version."""
    from gmf_tpu_torch.ops.fused_attention import _qscale

    d = q.shape[-1]
    q64, k64, v64, do64 = (t.double() for t in (q, k, v, do))
    logits = compat.double() * ((q64 * _qscale(d)) @ k64.transpose(-1, -2))
    logits = torch.where(mask[:, None, :] > 0, logits,
                         torch.full_like(logits, -1e9))
    p = torch.exp2(logits - logits.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True) * (mask[..., None] > 0)
    del logits
    delta = (do64 * (p @ v64)).sum(-1, keepdim=True)
    ds = p * (do64 @ v64.transpose(-1, -2) - delta) * compat.double() / (
        math.sqrt(d))
    exact = (ds @ k64, ds.transpose(-1, -2) @ q64,
             p.transpose(-1, -2) @ do64)
    del p, ds
    res = {}
    for part, g, r, x in zip(("dq", "dk", "dv"), got, ref, exact):
        scale = x.abs().max().item()
        kernel = (g.double() - x).abs().max().item() / scale
        plain = (r.double() - x).abs().max().item() / scale
        if not kernel <= 2 * plain:
            fail(f"backward {tag} {part}: {kernel} of the largest entry from "
                 f"the f64 backward, more than twice the plain f32 "
                 f"version's {plain}")
        res[part] = dict(kernel=kernel, plain=plain, limit=2 * plain)
    return res


def bwd_pair_boundary(dev, gen):
    """The four backward kernels across the pair boundary: pair 0 at N =
    333, whose last tiles reach into pair 1, with pair 1's k, v and do all
    inf, and for the streaming kernels its keypoints too. The kernels must
    not read them: pair 0's gradients meet ``bwd_tol`` against the plain
    backward on pair 0 alone. f32 and bf16, streaming and each cache type.
    Returns the largest error over its limit, by kernel name."""
    from gmf_tpu_torch.ops.fused_attention import (
        _cached_forward, _streaming_forward, build_compat_cache, bwd_dkv,
        bwd_dq, bwd_inputs, compat_attention_bwd_plain)

    n, p = 333, slice(0, 1)
    src = 2.5 * torch.rand(2, n, 3, generator=gen, device=dev)
    tgt = src + 0.02 * torch.randn(2, n, 3, generator=gen, device=dev)
    src_inf, tgt_inf = src.clone(), tgt.clone()
    src_inf[1] = float("inf")
    tgt_inf[1] = float("inf")
    mask = torch.ones(2, n, device=dev)
    worst = dict.fromkeys(BWD_KERNELS.values(), 0.0)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, do = (torch.randn(2, n, D, generator=gen, device=dev)
                       .to(dtype) for _ in range(4))
        for t in (k, v, do):
            t[1] = float("inf")
        for cdt in (None, torch.float32, torch.bfloat16, torch.int8):
            if cdt is None:
                cache = None
                out, lse = _streaming_forward(q, k, v, src_inf, tgt_inf, mask,
                                              0.10, True)
            else:
                cache = build_compat_cache(src, tgt, 0.10, cdt)
                out, lse = _cached_forward(q, k, v, cache, mask, True)
            inp = bwd_inputs(q, k, v, do, out, lse, mask)
            got_k, got_v = bwd_dkv(inp, src_inf, tgt_inf, 0.10, cache)
            got_q = bwd_dq(inp, src_inf, tgt_inf, 0.10, cache)
            refs = compat_attention_bwd_plain(
                q[p], k[p], v[p], do[p], out[p], lse[p], mask[p], src[p],
                tgt[p], 0.10, compat=None if cache is None else cache[p])
            for part, g, r in zip(("dq", "dk", "dv"), (got_q, got_k, got_v),
                                  refs):
                tol = bwd_tol(r, dtype)
                err = (g[p].float() - r.float()).abs().max().item()
                if not err <= tol:
                    fail(f"backward {part} at the pair boundary ({dtype}, "
                         f"{cdt or 'streaming'}): max abs err {err} > {tol}")
                name = BWD_KERNELS[("dq" if part == "dq" else "dkv",
                                    cache is None)]
                worst[name] = max(worst[name], err / tol)
    return worst


def backward_phase(dev, rates):
    """Every kernel of the training paths at the training shape B=16,
    N=1000, D=128 with the last 10% of pair 0 masked: kernels 2, 3, 7 and
    8 against the plain backward; kernels 1 and 6 (output and lse) against
    the plain forward; kernel 4's cache of each type against its plain
    version in every byte, to its transpose, to zero pads and to a second
    launch (``cache_checks``), and timed; kNN and counts at S=100 seeds,
    k=40 with
    kernel_phase's limits. Attention in f32 and bf16, the cached kernels
    on each cache type. The backward kernels get the same out and lse as
    the plain backward. Limits: forward outputs as in kernel_phase
    (attention_tol); backward ``bwd_tol``; lse 1e-5 absolute (summation
    order), and each valid row's p = exp2(s - lse) sums to 1 within 1e-5
    (f32). The backward kernels must also give the same bits in two
    launches, hold across the pair boundary (``bwd_pair_boundary``) and,
    in f32, lie within twice the plain f32 backward's distance from the
    f64 backward (``f32_backward_f64_check``)."""
    from gmf_tpu_torch.data.synthetic import make_correspondence_problem
    from gmf_tpu_torch.ops.fused_attention import (
        _cached_forward, _load_compat, _logits_plain, _stream_compat_plain,
        _streaming_forward, build_compat_cache, build_compat_cache_plain,
        bwd_dkv, bwd_dq, bwd_inputs, cache_row_stride,
        compat_attention_bwd_plain, compat_attention_cached_plain,
        compat_attention_plain)

    b, n = B_TRAIN, N_TRAIN
    f32, bf16, i8 = torch.float32, torch.bfloat16, torch.int8
    names = {f32: "f32", bf16: "bf16", i8: "int8"}
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    prob = make_correspondence_problem(np.random.RandomState(SEED + 3),
                                       num_corr=n, inlier_ratio=0.5,
                                       image_hw=(8, 8), batch=b)
    src = torch.tensor(prob["src_keypts"], device=dev)
    tgt = torch.tensor(prob["tgt_keypts"], device=dev)
    mask = torch.ones(b, n, device=dev)
    mask[0, n - n // 10:] = 0.0
    valid = mask > 0
    seed_errs, seed_rows = seed_kernels_check(
        f"B={b}, N={n}", gen, prob["gt_trans"], src, tgt, mask, S_TRAIN,
        [slice(0, b)], rates)
    res, cache_rows = {}, {}
    for dtype in (f32, bf16):
        q, k, v, do = (torch.randn(b, n, D, generator=gen, device=dev)
                       .to(dtype) for _ in range(4))
        for cdt in (None, f32, bf16, i8):
            tag = f"{names[dtype]}_{'stream' if cdt is None else names[cdt]}"
            cache = None if cdt is None else build_compat_cache(src, tgt,
                                                                0.10, cdt)
            if cache is None:
                out, lse = _streaming_forward(q, k, v, src, tgt, mask, 0.10,
                                              True)
                ref_out, ref_lse = compat_attention_plain(
                    q, k, v, src, tgt, mask, return_lse=True)
                compat = _stream_compat_plain(src, tgt, 0.10)
            else:
                if dtype == f32:
                    cache_checks(
                        f"{names[cdt]} at B={b}, N={n}", cache,
                        build_compat_cache_plain(src, tgt, 0.10, cdt),
                        lambda: build_compat_cache(src, tgt, 0.10, cdt))
                    cache_rows[cdt] = dict(
                        ms=cuda_ms(lambda: build_compat_cache(
                            src, tgt, 0.10, cdt), reps=20),
                        **cache_bound(rates, cdt, b, n))
                out, lse = _cached_forward(q, k, v, cache, mask, True)
                ref_out, ref_lse = compat_attention_cached_plain(
                    q, k, v, cache, mask, return_lse=True)
                compat = _load_compat(cache, n)
            fwd_tol, _ = attention_tol(ref_out, dtype)
            fwd_err = (out.float() - ref_out.float()).abs().max().item()
            if not fwd_err <= fwd_tol:
                fail(f"forward {tag}: max abs err {fwd_err} > {fwd_tol}")
            f64_errs = None
            if dtype == f32:
                f64_errs = f32_forward_f64_check(tag, q, k, v, compat, mask,
                                                 out, ref_out)
            del ref_out
            lse_err = (lse - ref_lse)[valid].abs().max().item()
            if not lse_err <= 1e-5:
                fail(f"lse {tag}: differs from the plain forward's by "
                     f"{lse_err}")
            psum_err = None
            if dtype == f32:
                psum = torch.exp2(_logits_plain(q, k, compat, mask)
                                  - lse[..., None]).sum(-1)
                psum_err = (psum[valid] - 1.0).abs().max().item()
                if not psum_err <= 1e-5:
                    fail(f"lse {tag}: recomputed p sums to 1 within "
                         f"{psum_err} only")
            inp = bwd_inputs(q, k, v, do, out, lse, mask)
            got_k, got_v = bwd_dkv(inp, src, tgt, 0.10, cache)
            got_q = bwd_dq(inp, src, tgt, 0.10, cache)
            ref_q, ref_k, ref_v = compat_attention_bwd_plain(
                q, k, v, do, out, lse, mask, src, tgt, 0.10, compat=cache)
            again_k, again_v = bwd_dkv(inp, src, tgt, 0.10, cache)
            if not (torch.equal(again_k, got_k)
                    and torch.equal(again_v, got_v)
                    and torch.equal(bwd_dq(inp, src, tgt, 0.10, cache),
                                    got_q)):
                fail(f"backward {tag}: two launches differ")
            del again_k, again_v
            bwd_f64 = None
            if dtype == f32:
                bwd_f64 = f32_backward_f64_check(
                    tag, q, k, v, do, compat, mask, (got_q, got_k, got_v),
                    (ref_q, ref_k, ref_v))
            del compat
            errs = {}
            for part, g, r in (("dq", got_q, ref_q), ("dk", got_k, ref_k),
                               ("dv", got_v, ref_v)):
                tol = bwd_tol(r, dtype)
                err = (g.float() - r.float()).abs().max().item()
                if not err <= tol:
                    fail(f"backward {tag} {part}: max abs err {err} > {tol}")
                errs[part] = (err, tol)
            if not (got_q[~valid] == 0).all():
                fail(f"backward {tag}: masked query rows got a gradient")
            del got_q, got_k, got_v, ref_q, ref_k, ref_v
            row = dict(fwd_err=fwd_err, fwd_tol=fwd_tol, lse_err=lse_err,
                       psum_err=psum_err, errs=errs, fwd_f64=f64_errs,
                       bwd_f64=bwd_f64)
            row["dkv_ms"] = cuda_ms(
                lambda: bwd_dkv(inp, src, tgt, 0.10, cache), reps=10)
            row["dq_ms"] = cuda_ms(
                lambda: bwd_dq(inp, src, tgt, 0.10, cache), reps=10)
            row["plain_ms"] = cuda_ms(lambda: compat_attention_bwd_plain(
                q, k, v, do, out, lse, mask, src, tgt, 0.10, compat=cache),
                reps=2, warmup=1)
            if cache is None:
                side = b * n * 6 * 4
                alu, sfu = (26, 3)  # compat 20, p and dlogits 6; 2 sqrt, exp2
                fwd = lambda lse_on: _streaming_forward(  # noqa: E731
                    q, k, v, src, tgt, mask, 0.10, lse_on)
            else:
                side = b * n * cache_row_stride(n, cdt) * cache.element_size()
                alu, sfu = (9, 1)  # dequantize, logit, p, dlogits; exp2
                fwd = lambda lse_on: _cached_forward(  # noqa: E731
                    q, k, v, cache, mask, lse_on)
            row["dkv_bound"] = bwd_bound(rates, dtype, side, alu, sfu, 4, 2)
            row["dq_bound"] = bwd_bound(rates, dtype, side, alu, sfu, 3, 1)
            if dtype == f32 and cdt in (None, f32):
                # the forward at the training shape, with and without lse,
                # beside its bound there
                row["fwd_ms_lse"] = cuda_ms(lambda: fwd(True), reps=10)
                row["fwd_ms_no_lse"] = cuda_ms(lambda: fwd(False), reps=10)
                row["fwd_bound"] = attention_bound(rates, f32, cdt, b=b, n=n)
            res[tag] = row
            del inp, out, lse, cache
            torch.cuda.empty_cache()
        del q, k, v, do
    boundary = bwd_pair_boundary(dev, gen)
    summary = {t: {"fwd_err": r["fwd_err"], "lse_err": r["lse_err"],
                   "psum_err": r["psum_err"], "fwd_f64": r["fwd_f64"],
                   "bwd_f64": r["bwd_f64"],
                   **{p: e[0] for p, e in r["errs"].items()},
                   "dkv_ms": r["dkv_ms"], "dq_ms": r["dq_ms"]}
               for t, r in res.items()}
    print(f"training-shape kernels passed: {json.dumps(seed_errs)} "
          f"{json.dumps(summary)}; backward at the pair boundary, "
          f"error over limit: {json.dumps(boundary)}", flush=True)

    def rows_for(main, name_dkv, name_dq):
        """The two kernels' rows: the f32 training case first, every other
        type and cache beside it."""
        out = {}
        for part, name in (("dkv", name_dkv), ("dq", name_dq)):
            grads = ("dk", "dv") if part == "dkv" else ("dq",)
            tags = [t for t in res
                    if t.endswith("stream") == main.endswith("stream")]
            m = res[main]
            out[name] = dict(
                dtype="f32", shape=[b, n, D],
                max_abs_err=max(m["errs"][g][0] for g in grads),
                tolerance=min(m["errs"][g][1] for g in grads),
                ms=m[f"{part}_ms"], plain_ms=m["plain_ms"],
                plain_covers="dq, dk and dv together",
                bound_ms=m[f"{part}_bound"][0],
                bound_by=m[f"{part}_bound"][1],
                variants={t: dict(ms=res[t][f"{part}_ms"],
                                  bound_ms=res[t][f"{part}_bound"][0],
                                  max_abs_err=max(res[t]["errs"][g][0]
                                                  for g in grads),
                                  tolerance=min(res[t]["errs"][g][1]
                                                for g in grads))
                          for t in tags})
        return out

    rows = rows_for("f32_stream", "compat_flash_attention_bwd_dkv",
                    "compat_flash_attention_bwd_dq")
    rows.update(rows_for("f32_f32", "compat_flash_attention_cached_bwd_dkv",
                         "compat_flash_attention_cached_bwd_dq"))
    fwd = {"compat_flash_attention": ("f32_stream", ["bf16_stream"]),
           "compat_flash_attention_cached": (
               "f32_f32", ["bf16_f32", "bf16_bf16", "bf16_int8"])}
    extra = {}
    for name, (main, bf16_tags) in fwd.items():
        r = res[main]
        extra[name] = dict(
            b16_n1000_f32_ms_with_lse=r["fwd_ms_lse"],
            b16_n1000_f32_ms_without_lse=r["fwd_ms_no_lse"],
            b16_n1000_f32_bound_ms=r["fwd_bound"][0],
            b16_n1000_f32_bound_by=r["fwd_bound"][1],
            b16_n1000_f32_max_abs_err=r["fwd_err"],
            b16_n1000_bf16_max_abs_err=max(res[t]["fwd_err"]
                                           for t in bf16_tags),
            b16_n1000_lse_max_abs_err=r["lse_err"],
            b16_n1000_p_sum_err=r["psum_err"])
    extra["build_compat_cache"] = dict(
        b16_n1000_equal_to_plain=True,
        b16_n1000_symmetric_pads_zero_two_launches_equal=True,
        **{f"b16_n1000_{names[c]}_{k}": v for c, r in cache_rows.items()
           for k, v in r.items()})
    for (kernel, stream), name in BWD_KERNELS.items():
        grads = ("dk", "dv") if kernel == "dkv" else ("dq",)
        extra[name] = dict(
            two_launches_same_bits=True,
            pair_boundary_n333_err_over_limit=boundary[name],
            f32_vs_f64={t: {g: res[t]["bwd_f64"][g] for g in grads}
                        for t in res if res[t]["bwd_f64"] is not None
                        and t.endswith("stream") == stream})
    for name, err in seed_errs.items():
        extra[name] = {"b16_n1000_max_abs_err": err}
    for name, row in seed_rows.items():  # the training shape's kNN, counts
        extra[name].update({f"b16_n1000_{k}": v for k, v in row.items()
                            if k in ("ms", "plain_ms", "bound_ms")})
    return rows, extra


def variant_bound(rates, variant, b, n, dtype=torch.bfloat16):
    """(bound_ms, bound_by) of one layer of ``variant`` at [b, n, D]: q,
    k, v read and out written in ``dtype``, the keypoints (v0, v2, v3, v6)
    or the cache (v4 bf16, v5 f32), the two products of depth D per (i, j)
    at ``product_rate`` and VARIANT_OPS. The
    benchmark passes no mask."""
    from gmf_tpu_torch.ops.flash_variants import CACHE_DTYPES
    from gmf_tpu_torch.ops.fused_attention import cache_row_stride

    pairs = b * n * n
    nbytes = 4 * b * n * D * (torch.finfo(dtype).bits // 8)
    if variant in CACHE_DTYPES:
        cdt = CACHE_DTYPES[variant]
        nbytes += (b * n * cache_row_stride(n, cdt)
                   * (torch.finfo(cdt).bits // 8))
    elif variant != "v1":
        nbytes += b * n * 6 * 4
    alu, sfu = VARIANT_OPS[variant]
    return rates.bound(nbytes, {
        "products": 4 * D * pairs / product_rate(dtype),
        "alu": alu * pairs / rates.alu, "sfu": sfu * pairs / rates.sfu})


def precompute_row(rates, cdt, src, tgt, slices, cache):
    """The standalone cache of ``cdt`` (kernel 4, the microbenchmark's
    precompute) that the kernel built from ``src`` and ``tgt``, held
    against its plain version on each slice of pairs in every byte, to its
    transpose, its pad columns to 0 and a second launch to the same bytes
    (``cache_checks``); its time (CUDA events, this script's own) and the
    plain version's, the bounds at that shape."""
    from gmf_tpu_torch.ops.fused_attention import (build_compat_cache,
                                                   build_compat_cache_plain)

    def plain():
        return [build_compat_cache_plain(src[sl], tgt[sl], 0.10, cdt)
                for sl in slices]

    b, n, _ = src.shape
    for sl, ref in zip(slices, plain()):
        if not torch.equal(cache[sl], ref):
            fail(f"build_compat_cache {cdt} at B={b}, pairs "
                 f"{sl.start}..{sl.stop - 1}: differs from its plain "
                 "version")
        del ref
    cache_checks(f"{cdt} at B={b}", cache, None,
                 lambda: build_compat_cache(src, tgt, 0.10, cdt))
    return dict(precompute_kernel_ms=cuda_ms(
        lambda: build_compat_cache(src, tgt, 0.10, cdt), reps=5),
        precompute_plain_ms=cuda_ms(plain, reps=1, warmup=0),
        **{f"precompute_{k}": v
           for k, v in cache_bound(rates, cdt, b, n).items()})


def variants_phase(dev, rates):
    """The attention-variant microbenchmark's kernels and its run.

    1. Each of the four instances of compat_flash_variants.cu (v0, v1, v3,
       v6) against flash_variant_plain at kernel_phase's shape (B=8,
       N=5000 with 4000 valid rows in pair 0, D=128) in bf16 and f32, and
       at a ragged N=333, with kernel_phase's limits (attention_tol);
       their time and the plain version's at 8 x 5000.
    2. The benchmark through its entry point at its full size (B=64,
       N=5000, D=128, 12 layers) with VARIANT_ITERS timed stacks: the
       path of these kernels. Launch counts are reset just before and
       read just after, and must be VARIANT_BENCH_LAUNCHES exactly. Every
       time and difference it reports must be finite.
    3. One layer of each variant's kernel on the benchmark's own input
       (B=64, N=5000, q = k = v, no mask) against its plain version run
       in slices of 8 pairs, with the limits of step 1: flash_variant for
       v0-v3 and v6, and for v4 and v5 the standalone cache (every byte
       against the plain one) and the cached kernel on it. The plain
       version's time and each variant's bound at that shape.
    Returns the kernel rows of the four instances and the summary."""
    from gmf_tpu_torch.ops import _build
    from gmf_tpu_torch.ops.flash_variants import (
        CACHE_DTYPES, VARIANTS, flash_variant, flash_variant_plain)
    from gmf_tpu_torch.ops.fused_attention import (
        build_compat_cache, build_compat_cache_plain,
        compat_attention_cached_plain)
    from gmf_tpu_torch.tools import bench_flash_variants as bench

    f32, bf16 = torch.float32, torch.bfloat16
    names = {f32: "f32", bf16: "bf16"}
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    _, src, tgt, mask = make_inputs(dev)
    checks = {v: {} for v in VARIANT_KERNELS}
    for dtype in (f32, bf16):
        q, k, v = (torch.randn(B, N, D, generator=gen, device=dev).to(dtype)
                   for _ in range(3))
        n_r = 333
        qr, kr, vr = (torch.randn(B, n_r, D, generator=gen, device=dev)
                      .to(dtype) for _ in range(3))
        src_r = 2.5 * torch.rand(B, n_r, 3, generator=gen, device=dev)
        tgt_r = src_r + 0.02 * torch.randn(B, n_r, 3, generator=gen,
                                           device=dev)
        for variant in VARIANT_KERNELS:
            c = checks[variant]
            main = f"b{B}_n{N}_{names[dtype]}"
            for tag, args in ((main, (q, k, v, src, tgt, mask)),
                              (f"b{B}_n{n_r}_{names[dtype]}",
                               (qr, kr, vr, src_r, tgt_r, None))):
                got = flash_variant(*args, variant=variant)
                ref = flash_variant_plain(*args, variant=variant)
                tol, ref_max = attention_tol(ref, dtype)
                err = (got.float() - ref.float()).abs().max().item()
                if not err <= tol:
                    fail(f"{VARIANT_KERNELS[variant]} {tag}: max abs err "
                         f"{err} > {tol}")
                c[f"{tag}_max_abs_err"] = err
                c[f"{tag}_tolerance"] = tol
                del got, ref
            c[f"{main}_ms"] = cuda_ms(lambda: flash_variant(
                q, k, v, src, tgt, mask=mask, variant=variant), reps=5)
            c[f"{main}_plain_ms"] = cuda_ms(
                lambda: flash_variant_plain(q, k, v, src, tgt, mask=mask,
                                            variant=variant),
                reps=2, warmup=1)
            c[f"{main}_bound_ms"] = variant_bound(rates, variant, B, N,
                                                  dtype)[0]
        del q, k, v, qr, kr, vr
        torch.cuda.empty_cache()
    print(f"variant kernels vs plain passed: {json.dumps(checks)}",
          flush=True)

    # the benchmark: the path of the four instances
    torch.cuda.synchronize()
    _build.reset_launches()
    res = bench.main(["--iters", str(VARIANT_ITERS),
                      "--layers", str(VARIANT_LAYERS)])
    torch.cuda.synchronize()
    launches = {k: _build.launches[k] for k in KERNELS}
    for k in KERNELS:
        if launches[k] != VARIANT_BENCH_LAUNCHES.get(k, 0):
            fail(f"bench_flash_variants: {k} launched {launches[k]} times, "
                 f"expected {VARIANT_BENCH_LAUNCHES.get(k, 0)}")
    numbers = [res["sdpa"]["ms_per_stack"], res["sdpa"]["max_abs_diff_vs_v1"]]
    for row in res["variants"].values():
        numbers += [row["ms_per_stack"], row.get("precompute_ms", 1.0),
                    row["max_abs_diff_vs_v0"] or 0.0]
    if not all(math.isfinite(x) and x >= 0 for x in numbers):
        fail(f"bench_flash_variants: a time or difference is not finite: "
             f"{res}")
    # the library computes v1's function independently: after one layer
    # within attention_tol's 2 bf16 ulps of the largest output (the
    # stack's 12 layers amplify the two softmaxes' different roundings)
    sdpa = res["sdpa"]
    sdpa_tol = 2 * bf16_ulp(sdpa["one_layer_v1_max_abs_out"])
    if not sdpa["one_layer_max_abs_diff_vs_v1"] <= sdpa_tol:
        fail(f"scaled_dot_product_attention and v1 differ by "
             f"{sdpa['one_layer_max_abs_diff_vs_v1']} > {sdpa_tol} after "
             "one layer")
    b, n = res["batch"], res["num_corr"]

    # each variant's kernel against its plain version, one layer of the
    # benchmark's input; plain times and bounds at that shape
    q, src64, tgt64 = bench.make_inputs(b, n, dev)
    slices = [slice(s0, s0 + B) for s0 in range(0, b, B)]
    summary = {}
    for variant in VARIANTS:
        pre = {}
        if variant in CACHE_DTYPES:
            cdt = CACHE_DTYPES[variant]
            cache = build_compat_cache(src64, tgt64, bench.SIGMA_D, cdt)
            pre = precompute_row(rates, cdt, src64, tgt64, slices, cache)
            got = bench.cached_layer(q, cache)
        else:
            cache = None
            got = bench.variant_layer(q, variant, src64, tgt64)

        def plain_layer():
            if cache is None:
                return torch.cat([flash_variant_plain(
                    q[sl], q[sl], q[sl], src64[sl], tgt64[sl],
                    variant=variant, sigma_d=bench.SIGMA_D)
                    for sl in slices])
            return torch.cat([compat_attention_cached_plain(
                q[sl], q[sl], q[sl], cache[sl]) for sl in slices])

        ref = plain_layer()
        tol, _ = attention_tol(ref, torch.bfloat16)
        err = (got.float() - ref.float()).abs().max().item()
        if not err <= tol:
            fail(f"bench_flash_variants {variant} at B={b}, N={n}: max abs "
                 f"err {err} > {tol} against the plain version")
        del got, ref
        bound_ms, bound_by = variant_bound(rates, variant, b, n)
        summary[variant] = dict(
            res["variants"][variant],
            max_abs_err=err, tolerance=tol,
            plain_ms_per_layer=cuda_ms(plain_layer, reps=1, warmup=0),
            bound_ms_per_layer=bound_ms, bound_by=bound_by, **pre,
            kernel=VARIANT_KERNELS.get(variant, {
                "v2": "compat_flash_attention"}.get(
                    variant, "compat_flash_attention_cached")))
        del cache
        torch.cuda.empty_cache()
    del q, src64, tgt64
    out = dict(batch=b, num_corr=n, layers=res["layers"],
               iters=res["iters"], launches=launches, variants=summary,
               sdpa=res["sdpa"], card=res["card"])
    print(f"path bench_flash_variants: {json.dumps(out)}", flush=True)

    rows = {}
    for variant, name in VARIANT_KERNELS.items():
        c, r = checks[variant], summary[variant]
        rows[name] = dict(
            dtype="bf16", shape=[b, n, D], variant=variant,
            max_abs_err=r["max_abs_err"], tolerance=r["tolerance"],
            ms=r["ms_per_layer"],
            plain_ms=r["plain_ms_per_layer"],
            bound_ms=r["bound_ms_per_layer"], bound_by=r["bound_by"],
            library_ms=None, **c)
    rows[VARIANT_KERNELS["v1"]].update(
        library_ms=res["sdpa"]["ms_per_layer"],
        library=("torch.nn.functional.scaled_dot_product_attention, one "
                 f"head, backend {res['sdpa']['backend']}"))
    # the benchmark's launches of kernels 1, 4 and 6, held at its shape
    extra = {"compat_flash_attention": {
                 "bench_v2_b64_max_abs_err": summary["v2"]["max_abs_err"]},
             "compat_flash_attention_cached": {
                 f"bench_{v}_b64_max_abs_err": summary[v]["max_abs_err"]
                 for v in CACHE_DTYPES},
             "build_compat_cache": {
                 "bench_b64_bf16_f32_max_abs_err": 0.0,
                 "b64_symmetric_pads_zero_two_launches_equal": True,
                 **{f"b64_{names[CACHE_DTYPES[v]]}_{key}": summary[v][k]
                    for v in CACHE_DTYPES
                    for key, k in (("ms", "precompute_kernel_ms"),
                                   ("bound_ms", "precompute_bound_ms"),
                                   ("bound_by", "precompute_bound_by"),
                                   ("bound_all_entries_ms",
                                    "precompute_bound_all_entries_ms"))}}}
    return rows, out, extra


def make_trainer(dev, compat_cache, batch_size=B_TRAIN, steps=1,
                 num_corr=N_TRAIN, fused_attention=True, num_layers=12):
    """The reference's 3DMatch training configuration at full width (12
    layers unless ``num_layers`` cuts the depth, 128 channels, k=40,
    ratio 0.1, sigma_d 0.10, 120x160 images), f32, random weights from
    SEED, behind the port's Trainer on synthetic batches of
    ``batch_size`` pairs of ``num_corr`` correspondences."""
    from gmf_tpu_torch.data.synthetic import SyntheticCorrespondenceLoader
    from gmf_tpu_torch.models import PointDSC
    from gmf_tpu_torch.train.trainer import TrainConfig, Trainer

    model = PointDSC(num_layers=num_layers, num_channels=128, k=40,
                     ratio=0.1, sigma_d=0.10, compat_cache=compat_cache,
                     fused_attention=fused_attention, dtype=torch.float32,
                     device=dev, seed=SEED)
    loader = SyntheticCorrespondenceLoader(
        batch_size=batch_size, num_corr=num_corr, steps_per_epoch=steps,
        image_hw=IMAGE_HW, seed=SEED)
    return Trainer(model, TrainConfig(), loader, loader)


def train_path(name, dev):
    """Drive one path of TRAIN_PATHS through Trainer.train_step, with the
    launch counts reset just before and read just after. Fails on a wrong
    launch count, a cache of another type, a skipped step or a non-finite
    loss. Times the steps after the first two (host clock around
    synchronised steps)."""
    from gmf_tpu_torch.ops import _build

    spec = TRAIN_PATHS[name]
    fused = spec.get("fused_attention", True)
    trainer = make_trainer(dev, spec["compat_cache"], steps=spec["steps"],
                           fused_attention=fused)
    caches = []
    hook = trainer.model.encoder.register_forward_pre_hook(
        lambda mod, args, kwargs: caches.append(
            None if kwargs.get("compat_cache") is None
            else kwargs["compat_cache"].dtype), with_kwargs=True)
    batches = list(trainer.train_loader)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    times, metrics = [], []
    for batch in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics.append(trainer.train_step(batch, epoch=1))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = {k: _build.launches[k] for k in KERNELS}
    peak = torch.cuda.max_memory_allocated()
    hook.remove()
    for k in KERNELS:
        want = spec["per_step"].get(k, 0) * len(batches)
        if launches[k] != want:
            fail(f"path {name}: {k} launched {launches[k]} times, expected "
                 f"{want}")
    if any(c != spec["cache"] for c in caches):
        fail(f"path {name}: the layers got caches of {caches}")
    for m in metrics:
        if m["skipped_step"] != 0.0 or not math.isfinite(m["loss"]):
            fail(f"path {name}: a step was skipped or its loss is not "
                 f"finite: {m}")
    timed = times[2:] if len(times) > 2 else times[1:]
    out = dict(compat_cache=spec["compat_cache"], fused_attention=fused,
               cache_type=str(spec["cache"]), steps=len(batches),
               pairs_per_step=B_TRAIN, num_corr=N_TRAIN, launches=launches,
               launches_per_step=spec["per_step"],
               losses=[m["loss"] for m in metrics],
               ms_per_step=1e3 * float(np.mean(timed)),
               timed_steps=len(timed),
               step_ms_all=[1e3 * t for t in times],
               pairs_per_s=B_TRAIN / float(np.mean(timed)),
               peak_memory_bytes=peak)
    print(f"path {name}: " + json.dumps(
        {k: v for k, v in out.items() if k not in ("launches",)}),
        flush=True)
    del trainer
    torch.cuda.empty_cache()
    return out


def cpu_reference_steps(model, batch, compat_cache):
    """The train step of copies of ``model`` on the CPU through the plain
    versions: in f64 (modules in f64; the attention, compat and geometry
    keep their f32 arithmetic), the reference, and in f32 at 8 and at 4
    threads, whose distance from it is what an f32 step's own rounding
    gives. "auto" takes the f32 cache on the card, so the CPU models take
    "f32". Returns {name: (model, metrics, seconds)}."""
    from gmf_tpu_torch.train.trainer import TrainConfig, Trainer

    runs, threads_before = {}, torch.get_num_threads()
    for name, dtype, threads in (("f64", torch.float64, 8),
                                 ("f32_8", torch.float32, 8),
                                 ("f32_4", torch.float32, 4)):
        torch.set_num_threads(threads)
        cpu = copy.deepcopy(model).to("cpu", dtype)
        cpu.compat_cache = "f32" if compat_cache == "auto" else compat_cache
        t0 = time.perf_counter()
        metrics = Trainer(cpu, TrainConfig(), [], [],
                          steps_per_epoch=1).train_step(batch, epoch=1)
        runs[name] = (cpu, metrics, time.perf_counter() - t0)
    torch.set_num_threads(threads_before)
    return runs


def leaf_tol(scale, cpu_err):
    """The bound on one parameter's gradient error against the f64 step,
    from its largest f64 entry and the farther f32 CPU step's error on it.
    Where that error reaches the gradient itself, f32 cannot resolve the
    gradient (a bias before a batch norm, whose true gradient is 0): the
    card's value is then noise too, and noise of another summation order
    may be several times that of the two CPU orders (5.4x at one thread
    against 8 and 4, tests/test_torch_trainer.py), so 8 times it."""
    if cpu_err >= scale:
        return 8 * cpu_err + 1e-6
    return max(2e-3 * scale + 1e-6, 2 * cpu_err)


def compare_train_step(model, batch, cpu_runs):
    """One f32 train step of ``model`` on the card against ``cpu_runs``
    (cpu_reference_steps of the same model and batch).

    An f32 step of this full-depth network is itself far from exact: the
    CPU's f32 step lies 5.6e-3 of the largest gradient from the f64 one
    (PERF.md section 6), beyond the CPU tests' 2e-3. So each parameter's
    gradient (leaf) must lie within 2e-3 of that leaf's own largest f64
    entry plus 1e-6 (tests/test_torch_train.py's bound, per leaf) of the
    f64 step's, or within twice the farther of the two f32 CPU steps on
    that leaf, whichever is larger (leaf_tol). The loss within 1e-4
    relative. The new
    parameters must be Adam's first update from the card's own gradient,
    p - lr g / (|g| + eps) with g the gradient plus wd p, computed in f64,
    within 1e-6 of max(1, |p|). Returns the numbers, "ok" among them."""
    from gmf_tpu_torch.train.trainer import TrainConfig, Trainer

    cfg = TrainConfig()
    p0 = {n: p.detach().double().cpu() for n, p in model.named_parameters()}
    m_gpu = Trainer(model, cfg, [], [], steps_per_epoch=1).train_step(
        batch, epoch=1)
    _, m_ref, _ = cpu_runs["f64"]
    grads = {name: {n: p.grad.double().cpu() for n, p in m.named_parameters()}
             for name, m in (("gpu", model),
                             *((k, r[0]) for k, r in cpu_runs.items()))}
    leaves = []
    for n, want in grads["f64"].items():
        scale = want.abs().max().item()
        cpu_err = max((grads[k][n] - want).abs().max().item()
                      for k in ("f32_8", "f32_4"))
        err = (grads["gpu"][n] - want).abs().max().item()
        leaves.append((err / leaf_tol(scale, cpu_err), n, err, scale,
                       cpu_err))
    ratios = np.array([r[0] for r in leaves])
    worst = max(leaves)
    # the loosest bound against its leaf's own scale, among the leaves
    # that carry gradient (not the biases before a batch norm, whose true
    # gradient is 0)
    top = max(r[3] for r in leaves)
    loosest = max((leaf_tol(r[3], r[4]) / r[3], r[1])
                  for r in leaves if r[3] >= 1e-3 * top)
    adam_err = 0.0
    for n, p in model.named_parameters():
        g = grads["gpu"][n] + cfg.weight_decay * p0[n]
        want = p0[n] - cfg.lr * g / (g.abs() + 1e-8)
        adam_err = max(adam_err, ((p.detach().double().cpu() - want).abs()
                                  / p0[n].abs().clamp(min=1.0)).max().item())
    loss_err = abs(m_gpu["loss"] - m_ref["loss"]) / abs(m_ref["loss"])
    ok = bool(loss_err <= 1e-4 and worst[0] <= 1.0 and adam_err <= 1e-6
              and m_gpu["skipped_step"] == m_ref["skipped_step"] == 0.0)
    return dict(
        ok=ok, loss_gpu=m_gpu["loss"], loss_f64=m_ref["loss"],
        loss_cpu_f32=cpu_runs["f32_8"][1]["loss"], loss_rel_err=loss_err,
        grad_scale=top,
        grad_max_abs_err=max(r[2] for r in leaves),
        grad_cpu_f32_max_abs_err=max(r[4] for r in leaves),
        leaves=len(leaves),
        leaves_unresolved_in_f32=sum(r[4] >= r[3] for r in leaves),
        leaf_err_over_tol_max=worst[0],
        leaf_err_over_tol_median=float(np.median(ratios)),
        leaves_over_half_tol=int((ratios > 0.5).sum()),
        worst_leaf=dict(name=worst[1], err=worst[2], scale=worst[3],
                        cpu_f32_err=worst[4]),
        loosest_tol_over_scale=loosest[0], loosest_leaf=loosest[1],
        adam_update_max_err=adam_err,
        skipped_step=m_gpu["skipped_step"],
        cpu_step_seconds={k: r[2] for k, r in cpu_runs.items()})


def train_cpu_check(dev, compat_cache, pairs=B_TRAIN, fused_attention=True,
                    num_layers=12):
    """One f32 train step with the same weights and batch on the card
    (kernels) and on the CPU (plain versions) at the training main shape,
    full width and (unless ``num_layers`` cuts it) depth, held to
    compare_train_step's bounds. With ``fused_attention=False`` the dense
    path on both (the card's kernels there: kNN and counts)."""
    gpu = make_trainer(dev, compat_cache, batch_size=pairs,
                       fused_attention=fused_attention,
                       num_layers=num_layers)
    batch = next(iter(gpu.train_loader))
    cpu_runs = cpu_reference_steps(gpu.model, batch, compat_cache)
    mode = (f"compat_cache={compat_cache}" if fused_attention
            else "dense attention") + f", {num_layers} layers"
    out = dict(compat_cache=compat_cache, fused_attention=fused_attention,
               pairs=pairs, num_corr=N_TRAIN, num_layers=num_layers,
               **compare_train_step(gpu.model, batch, cpu_runs))
    print(f"f32 train step, {mode}, kernels (card) vs plain (CPU, f64): "
          f"{json.dumps(out)}", flush=True)
    if not out["ok"]:
        fail(f"f32 train step ({mode}) through the kernels disagrees with "
             "the plain versions")
    del gpu, cpu_runs
    torch.cuda.empty_cache()
    return out


def cli_phase():
    """The training command line on the card, synthetic data, one epoch of
    two steps, full width: without --fused (dense attention, the
    reference's default) and with it (the attention kernels). Each must
    exit 0 and leave its snapshots, whose config records the mode."""
    import os
    import tempfile

    runs = {}
    for fused in (False, True):
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            r = subprocess.run(
                [sys.executable, "-m", "gmf_tpu_torch.train.train_pointdsc",
                 "--dataset", "synthetic", "--max-epoch", "1",
                 "--steps-per-epoch", "2", "--save-dir", tmp]
                + (["--fused"] if fused else []),
                capture_output=True, text=True, timeout=600)
            seconds = time.perf_counter() - t0
            flag = " --fused" if fused else ""
            if r.returncode != 0:
                fail(f"train_pointdsc{flag} exited {r.returncode}:\n"
                     f"{r.stdout}\n{r.stderr[-4000:]}")
            snap = os.path.join(tmp, "model_best")
            if not os.path.exists(os.path.join(snap, "state.pt")):
                fail(f"train_pointdsc{flag} left no model_best snapshot")
            with open(os.path.join(snap, "config.json")) as f:
                recorded = json.load(f)["model"]["fused_attention"]
            if recorded is not fused:
                fail(f"train_pointdsc{flag} recorded fused_attention="
                     f"{recorded}")
        last = r.stdout.strip().splitlines()[-1]
        print(f"train_pointdsc{flag} on the card in {seconds:.1f} s: {last}",
              flush=True)
        runs["fused" if fused else "dense"] = dict(seconds=seconds,
                                                   last_line=last)
    return runs


def make_registrar(dev, dtype=torch.bfloat16, compat_cache="int8",
                   seed_solver="auto", num_corr=N, fused_attention=True,
                   num_layers=12):
    """A model at full width and depth (12 layers unless ``num_layers``
    cuts it; random weights from SEED, the same in every mode) behind a
    registrar with the one bucket ``num_corr``."""
    from gmf_tpu_torch.eval.registration import PointDSCRegistrar
    from gmf_tpu_torch.models import PointDSC

    model = PointDSC(num_layers=num_layers, num_channels=128, k=40,
                     ratio=0.1, compat_cache=compat_cache,
                     seed_solver=seed_solver,
                     fused_attention=fused_attention, dtype=dtype,
                     device=dev, seed=SEED)
    return PointDSCRegistrar(model, buckets=(num_corr,))


def make_requests(pairs, num_corr=N):
    """3 requests of ``pairs`` synthetic pairs of ``num_corr``
    correspondences; request 1 has between 4/5 of that and all of it."""
    from gmf_tpu_torch.data.synthetic import make_correspondence_problem

    rng = np.random.RandomState(SEED)
    requests = []
    for r in range(3):
        prob = make_correspondence_problem(rng, num_corr=num_corr,
                                           inlier_ratio=0.4,
                                           image_hw=IMAGE_HW, batch=pairs)
        samples = [{k: v[b] for k, v in prob.items()} for b in range(pairs)]
        if r == 1:
            for s in samples:
                n = int(rng.randint(4 * num_corr // 5, num_corr + 1))
                for key in ("corr_pos", "src_keypts", "tgt_keypts",
                            "labels"):
                    s[key] = s[key][:n]
        requests.append(samples)
    return requests


def rot_err_deg(Ta, Tb):
    c = (np.trace(Ta[:3, :3].T @ Tb[:3, :3]) - 1.0) / 2.0
    return math.degrees(math.acos(min(1.0, max(-1.0, c))))


def serve_path(name, dev, requests, timed=True):
    """Drive one path of PATHS: its requests once with the launch counts
    reset just before and read just after, then (``timed``) once more for
    the time per request. Fails on a wrong launch count, a malformed
    result or a registration recall under 0.9. Also returns, per counted
    request, the index of the seed that won each pair and the confidences
    the seeds were picked from (read from the model's output by a hook)."""
    from gmf_tpu_torch.ops import _build

    spec = PATHS[name]
    fused = spec.get("fused_attention", True)
    reg = make_registrar(dev, compat_cache=spec["compat_cache"],
                         seed_solver=spec["seed_solver"],
                         fused_attention=fused)
    winners = []
    hook = reg.model.register_forward_hook(
        lambda mod, args, out: winners.append(dict(
            seed=out["seed_fitness"].argmax(-1).cpu().numpy(),
            confidence=out["confidence"].cpu().numpy())))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    results = [reg.register_batch(req) for req in requests]
    torch.cuda.synchronize()
    hook.remove()
    launches = {k: _build.launches[k] for k in KERNELS}
    peak = torch.cuda.max_memory_allocated()
    for k in KERNELS:
        want = spec["per_forward"].get(k, 0) * len(requests)
        if launches[k] != want:
            fail(f"path {name}: {k} launched {launches[k]} times, "
                 f"expected {want}")
    rot, trn, ok = [], [], 0
    for req, res in zip(requests, results):
        if len(res) != len(req):
            fail(f"path {name}: {len(res)} results for {len(req)} pairs")
        for s, (trans, labels) in zip(req, res):
            if trans.shape != (4, 4) or not np.isfinite(trans).all():
                fail(f"path {name}: non-finite or misshapen transform")
            if labels.shape != (s["corr_pos"].shape[0],):
                fail(f"path {name}: labels of the wrong length")
            re_ = rot_err_deg(trans, s["gt_trans"])
            te = float(np.linalg.norm(trans[:3, 3] - s["gt_trans"][:3, 3]))
            rot.append(re_)
            trn.append(te)
            ok += re_ < 15.0 and te < 0.30
    if ok < 0.9 * len(rot):
        fail(f"path {name}: registration recall {ok}/{len(rot)}")
    out = dict(compat_cache=spec["compat_cache"],
               seed_solver=spec["seed_solver"], fused_attention=fused,
               pairs_per_request=spec["pairs"], requests=len(requests),
               launches=launches, recall=f"{ok}/{len(rot)}",
               median_rot_err_deg=float(np.median(rot)),
               median_trans_err_m=float(np.median(trn)),
               peak_memory_bytes=peak)
    if timed:
        times = []
        for req in requests:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            reg.register_batch(req)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        out["ms_per_request"] = 1e3 * float(np.mean(times))
        out["pairs_per_s"] = spec["pairs"] / float(np.mean(times))
    print(f"path {name}: " + json.dumps(
        {k: v for k, v in out.items() if k != "launches"}), flush=True)
    return out, results, winners


def make_fragments():
    """RAW_FRAGMENTS fragments of one synthetic scene of RAW_SCENE points:
    each RAW_POINTS of them, in the fragment's own frame (world = pose x)
    with 5 mm noise, with the scene point's RAW_DESC-d unit descriptor
    plus noise, normalised, and an image each."""
    from gmf_tpu_torch.geometry.se3 import random_rotation_matrix

    rng = np.random.RandomState(SEED)
    world = rng.rand(RAW_SCENE, 3) * 3.0
    desc = rng.randn(RAW_SCENE, RAW_DESC)
    frags = []
    for _ in range(RAW_FRAGMENTS):
        idx = rng.choice(RAW_SCENE, RAW_POINTS, replace=False)
        pose = np.eye(4)
        pose[:3, :3] = random_rotation_matrix(3, 1.0, rng)
        pose[:3, 3] = rng.rand(3)
        pts = (world[idx] - pose[:3, 3]) @ pose[:3, :3]
        d = desc[idx] + 0.1 * rng.randn(RAW_POINTS, RAW_DESC)
        frags.append(dict(
            keypts=(pts + 0.005 * rng.randn(RAW_POINTS, 3)).astype(
                np.float32),
            desc=(d / np.linalg.norm(d, axis=1, keepdims=True)).astype(
                np.float32),
            image=rng.rand(*IMAGE_HW, 3).astype(np.float32), pose=pose))
    return frags


def raw_samples(frags, pairs, keys=True):
    """Raw-descriptor samples of fragment pairs (i, j), fresh dicts (a
    fetch rewrites them), with fragment keys for the cache."""
    out = []
    for i, j in pairs:
        a, b = frags[i], frags[j]
        s = dict(src_keypts=a["keypts"].copy(), tgt_keypts=b["keypts"].copy(),
                 src_desc=a["desc"], tgt_desc=b["desc"], p_image=a["image"],
                 q_image=b["image"], gt_trans=(np.linalg.inv(b["pose"])
                                               @ a["pose"]).astype(
                                                   np.float32))
        if keys:
            s.update(src_key=i, tgt_key=j)
        out.append(s)
    return out


def raw_path(dev):
    """The raw-descriptor path: RAW_REQUESTS requests of RAW_PAIRS pairs
    drawn from the fragments, through dispatch_batch/fetch_batch of a
    registrar with a DeviceFragmentCache (int8 cache, bf16 modules), the
    launch counts reset just before and read just after. Fails on a wrong
    launch count, no cache hit on the second request, a transform other
    than register_batch's on the same pairs without the cache, matched
    rows other than build_correspondences' on the host (the fragments'
    real rows: every row, 5000 points in a bucket of 5000), or a
    registration recall under 0.9."""
    from gmf_tpu_torch.data.correspondence import build_correspondences
    from gmf_tpu_torch.eval.registration import DeviceFragmentCache
    from gmf_tpu_torch.ops import _build

    frags = make_fragments()
    rng = np.random.RandomState(SEED + 1)
    every = [(i, j) for i in range(RAW_FRAGMENTS)
             for j in range(RAW_FRAGMENTS) if i != j]
    picked = rng.choice(len(every), RAW_PAIRS * RAW_REQUESTS, replace=False)
    pairs = [[every[p] for p in picked[r * RAW_PAIRS:(r + 1) * RAW_PAIRS]]
             for r in range(RAW_REQUESTS)]
    reg = make_registrar(dev, torch.bfloat16, compat_cache="int8")
    reg.frag_cache = cache = DeviceFragmentCache()
    requests = [raw_samples(frags, p) for p in pairs]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    results, per_request = [], []
    for req in requests:
        t0 = time.perf_counter()
        handle = reg.dispatch_batch(req)
        t1 = time.perf_counter()
        results.append(reg.fetch_batch(handle))
        t2 = time.perf_counter()
        per_request.append(dict(dispatch_ms=1e3 * (t1 - t0),
                                fetch_ms=1e3 * (t2 - t1),
                                cache_hits=cache.hits,
                                cache_misses=cache.misses))
    launches = {k: _build.launches[k] for k in KERNELS}
    peak = torch.cuda.max_memory_allocated()
    for k in KERNELS:
        want = RAW_PER_FORWARD.get(k, 0) * len(requests)
        if launches[k] != want:
            fail(f"path raw_b16: {k} launched {launches[k]} times, expected "
                 f"{want}")
    if per_request[-1]["cache_hits"] <= per_request[0]["cache_hits"]:
        fail(f"path raw_b16: no fragment cache hit on the second request "
             f"({per_request})")
    # the same pairs through register_batch without the cache
    reg.frag_cache = None
    trans_diff, label_diff = 0.0, 0
    for p, res in zip(pairs, results):
        ref = reg.register_batch(raw_samples(frags, p, keys=False))
        for (t, lab), (t_ref, lab_ref) in zip(res, ref):
            trans_diff = max(trans_diff, float(np.abs(t - t_ref).max()))
            label_diff += int((lab != lab_ref).sum())
    # the matched rows against the host builder, and the registration
    rows_differ, kept, rot, trn, ok = 0, [], [], [], 0
    for p, req, res in zip(pairs, requests, results):
        for (i, j), s, (trans, labels) in zip(p, req, res):
            host = build_correspondences(
                frags[i]["keypts"], frags[j]["keypts"], frags[i]["desc"],
                frags[j]["desc"], s["gt_trans"], 0.10, use_mutual=True,
                in_dim=6)
            rows_differ += sum(
                host[k].shape != s[k].shape
                or not np.array_equal(host[k], s[k])
                for k in ("src_keypts", "tgt_keypts", "labels"))
            kept.append(len(s["labels"]))
            if labels.shape != (len(s["labels"]),):
                fail("path raw_b16: labels of the wrong length")
            if trans.shape != (4, 4) or not np.isfinite(trans).all():
                fail("path raw_b16: non-finite or misshapen transform")
            re_ = rot_err_deg(trans, s["gt_trans"])
            te = float(np.linalg.norm(trans[:3, 3] - s["gt_trans"][:3, 3]))
            rot.append(re_)
            trn.append(te)
            ok += re_ < 15.0 and te < 0.30
    out = dict(compat_cache="int8", dtype="bf16",
               pairs_per_request=RAW_PAIRS, requests=len(requests),
               fragments=RAW_FRAGMENTS, keypoints=RAW_POINTS,
               desc_dim=RAW_DESC, launches=launches,
               per_request=per_request,
               ms_per_request=float(np.mean(
                   [r["dispatch_ms"] + r["fetch_ms"] for r in per_request])),
               cache_entries=len(cache), cache_bytes=cache.nbytes,
               vs_register_batch_max_trans_diff=trans_diff,
               vs_register_batch_label_diffs=label_diff,
               vs_host_builder_fields_differ=rows_differ,
               matched_rows_min=min(kept), matched_rows_max=max(kept),
               recall=f"{ok}/{len(rot)}",
               median_rot_err_deg=float(np.median(rot)),
               median_trans_err_m=float(np.median(trn)),
               peak_memory_bytes=peak)
    print("path raw_b16: " + json.dumps(
        {k: v for k, v in out.items() if k != "launches"}), flush=True)
    if trans_diff != 0.0 or label_diff:
        fail("path raw_b16: the cached requests differ from register_batch "
             "on the same pairs")
    if rows_differ:
        fail("path raw_b16: matched rows differ from build_correspondences "
             "on the host")
    if ok < 0.9 * len(rot):
        fail(f"path raw_b16: registration recall {ok}/{len(rot)}")
    del reg, cache
    torch.cuda.empty_cache()
    return out


def f32_slice_check(dev, request, compat_cache, fused_attention=True,
                    num_layers=12):
    """Phase 5: f32 modules, the card through the kernels against the CPU
    through the plain versions. Bounds of the CPU parity tests
    (tests/test_torch_model.py, tests/test_fused_model.py): final_trans
    atol 1e-3, labels >= 0.99. ``fused_attention=False``: the dense path
    on both (dense attention and NMS; kNN and counts kernels on the
    card)."""
    from gmf_tpu_torch.eval.registration import PointDSCRegistrar

    reg32 = make_registrar(dev, torch.float32, compat_cache=compat_cache,
                           fused_attention=fused_attention,
                           num_layers=num_layers)
    cpu_model = copy.deepcopy(reg32.model).to("cpu")
    t0 = time.perf_counter()
    got = reg32.register_batch(request)
    ref = PointDSCRegistrar(cpu_model, buckets=(N,)).register_batch(request)
    seconds = time.perf_counter() - t0
    trans_err = [float(np.abs(g[0] - r[0]).max()) for g, r in zip(got, ref)]
    agree = [float((g[1] == r[1]).mean()) for g, r in zip(got, ref)]
    mode = (f"compat_cache={compat_cache}" if fused_attention
            else "dense attention") + f", {num_layers} layers"
    print(f"f32 slice, {mode}, kernels (card) vs plain (CPU), "
          f"{seconds:.1f} s: max |dT| per pair {trans_err}, label "
          f"agreement {agree}", flush=True)
    if max(trans_err) > 1e-3 or min(agree) < 0.99:
        fail(f"f32 slice ({mode}) through the kernels disagrees with the "
             "plain versions")
    return dict(compat_cache=compat_cache, fused_attention=fused_attention,
                num_layers=num_layers, max_trans_err=max(trans_err),
                min_label_agreement=min(agree),
                seconds=seconds)


def winning_correspondences(model, out):
    """Hook helper: record, for each pair of a forward, the index of the
    correspondence whose seed won (the NMS seeds recomputed from the
    model's own confidences, on the model's device)."""
    from gmf_tpu_torch.ops.fused_nms import pick_seeds_nms_fused

    def hook(mod, args, kwargs, result):
        src, mask = args[1], kwargs["corr_mask"]
        seeds = pick_seeds_nms_fused(
            src.float(), result["confidence"], mod.nms_radius,
            max(int(src.shape[1] * mod.ratio), 1), mask=mask)
        best = result["seed_fitness"].argmax(-1)
        out.extend(seeds.gather(1, best[:, None])[:, 0].cpu().tolist())

    return model.register_forward_hook(hook, with_kwargs=True)


def bf16_request(dev, request):
    """The bf16 int8-cache request that bf16_slice_check and
    bf16_seed_stage_check read, run once on the card (kernels) and once on
    the CPU (plain versions, a deepcopy of the same weights). Per side:
    the model, its results, the correspondence whose seed won each pair
    (winning_correspondences), the forward's inputs, mask and output and
    the encoder's output (hooks); and the seconds the two runs took."""
    from gmf_tpu_torch.eval.registration import PointDSCRegistrar

    reg16 = make_registrar(dev, torch.bfloat16, compat_cache="int8")
    runs = {"card": dict(model=reg16.model, won=[]),
            "cpu": dict(model=copy.deepcopy(reg16.model).to("cpu"), won=[])}
    hooks = []
    for run in runs.values():
        model = run["model"]
        hooks += [winning_correspondences(model, run["won"]),
                  model.register_forward_hook(
                      lambda mod, args, kwargs, out, run=run: run.update(
                          args=args, mask=kwargs["corr_mask"], out=out),
                      with_kwargs=True),
                  model.encoder.register_forward_hook(
                      lambda mod, args, out, run=run: run.update(enc=out))]
    t0 = time.perf_counter()
    runs["card"]["results"] = reg16.register_batch(request)
    runs["cpu"]["results"] = PointDSCRegistrar(
        runs["cpu"]["model"], buckets=(N,)).register_batch(request)
    seconds = time.perf_counter() - t0
    for h in hooks:
        h.remove()
    return runs, seconds


def bf16_slice_check(request, runs, seconds):
    """Phase 5, the serving dtype: bf16 modules with the int8 cache, the
    card through the kernels against the CPU through the plain versions,
    same weights, the f32 slices' pairs (bf16_request's runs). The two
    round bf16 apart (cuBLAS and the CPU's kernels; the kernels within 2
    ulps of their plain versions), so their confidences, and with them the
    seeds, may differ. A pair whose winning seed is the same
    correspondence on both is held to the f32 slices' bounds (final_trans
    1e-3, labels >= 0.99); the others are counted, and at least half the
    pairs must be held."""
    got, ref = runs["card"]["results"], runs["cpu"]["results"]
    won, won_cpu = runs["card"]["won"], runs["cpu"]["won"]
    held = [i for i in range(len(request)) if won[i] == won_cpu[i]]
    trans_err = max((float(np.abs(got[i][0] - ref[i][0]).max())
                     for i in held), default=0.0)
    agree = min((float((got[i][1] == ref[i][1]).mean()) for i in held),
                default=1.0)
    print(f"bf16 slice, compat_cache=int8, kernels (card) vs plain (CPU), "
          f"{seconds:.1f} s: the same seed won on {len(held)} of "
          f"{len(request)} pairs; there max |dT| {trans_err:.2e} (limit "
          f"1e-3), label agreement {agree} (limit 0.99)", flush=True)
    if trans_err > 1e-3 or agree < 0.99:
        fail("bf16 slice through the kernels disagrees with the plain "
             "versions on a pair whose winning seed is the same")
    if len(held) < 0.5 * len(request):
        fail("bf16 slice: another seed won on more than half the pairs")
    return dict(compat_cache="int8", dtype="bf16", pairs=len(request),
                same_seed=len(held), max_trans_err=trans_err,
                min_label_agreement=agree, seconds=seconds)


def bf16_ulps(a, b):
    """|a - b| in bf16 ulps at the larger magnitude, elementwise (f32)."""
    a, b = a.float(), b.float()
    big = torch.maximum(a.abs(), b.abs()).clamp(min=2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(big)) - 7)
    return (a - b).abs() / ulp


# how much farther than the CPU's bf16 encoder the card's may lie from the
# f32 encoder of the same weights, in its largest and in its mean distance
# (measured 0.987x in the largest and 1.004x in the mean, H100 80GB HBM3)
ENCODER_FROM_F32_LIMIT = 1.1


def bf16_seed_stage_check(runs):
    """Phase 5: where the bf16 int8-cache request of bf16_slice_check
    (bf16_request's runs) parts on the card from the CPU. The card's seed
    stage is run again step by step from its own encoder output
    (PointDSC's seed-stage methods; it must reproduce the card's forward),
    and every step is run on the CPU from the card's own inputs to it: NMS
    from the card's confidence, the kNN from the card's seeds and
    normalised features, the seed transforms from the card's
    neighbourhoods, the counts and fitness from the card's seed
    transforms. One line a step. The card's bf16 encoder must lie no
    farther from the f32 encoder (the same weights, on the CPU, on the
    CPU run's inputs) than ENCODER_FROM_F32_LIMIT times the CPU's bf16
    encoder, in the largest and in the mean distance. A step whose inputs
    are equal on both devices and that runs a kernel of the port must
    agree with its plain version: the seeds on every pair, the kNN's
    chosen scores within 1e-5, the counts exactly, the winners on every
    pair. Last, the CPU's seed stage chained from the card's encoder
    output (its features and confidence) must pick the card's winning
    correspondence on every pair."""
    card, cpu = runs["card"]["model"], runs["cpu"]["model"]
    t0 = time.perf_counter()
    src, tgt = (x.float() for x in runs["card"]["args"][1:3])
    mask, out, feats = (runs["card"][k] for k in ("mask", "out", "enc"))
    cpu_args, cpu_mask, cpu_out = (runs["cpu"][k]
                                   for k in ("args", "mask", "out"))
    pairs = src.shape[0]

    def c(x):
        return x.cpu()

    stages = {}
    with torch.inference_mode():
        # the f32 encoder of the same weights, on the CPU run's inputs
        cpu32 = copy.deepcopy(cpu).to("cpu", torch.float32)
        enc32 = cpu32._encode(cpu_args[0], cpu_args[1].float(),
                              cpu_args[2].float(), cpu_args[3], cpu_args[4],
                              cpu_mask.float(), True)
        del cpu32
        # the card, step by step from its encoder output
        normed, sigma, conf = card._seed_features(feats)
        seeds = card._pick_seeds(src, conf, mask)
        knn = card._seed_knn(seeds, normed, mask)
        strans = card._seed_transforms(normed, sigma, src, tgt, knn, True)
        counts, fit = card._seed_fitness(strans, src, tgt, mask)
        best = fit.argmax(-1)
        if not (torch.equal(conf, out["confidence"])
                and torch.equal(best, out["seed_fitness"].argmax(-1))):
            fail("bf16 seed stages: the step-by-step run does not reproduce "
                 "the card's forward")
        win = c(seeds.gather(1, best[:, None])[:, 0])
        valid = c(mask) > 0

        # 1. the encoder: the two devices end to end
        enc = bf16_ulps(c(feats), runs["cpu"]["enc"])[valid]
        diff = (c(feats).float() - runs["cpu"]["enc"].float()).abs()[valid]
        scale = enc32.abs()[valid].max().item()
        # each bf16 encoder's distance from the f32 one (same weights)
        from_f32 = {side: (runs[side]["enc"].float().cpu() - enc32).abs()[
            valid] for side in ("card", "cpu")}
        c_normed, c_sigma, c_conf = cpu._seed_features(c(feats))
        stages["encoder"] = dict(
            feats_max_ulps=enc.max().item(),
            feats_median_ulps=enc.median().item(),
            feats_share_apart=(enc > 0).float().mean().item(),
            feats_max_abs_diff=diff.max().item(),
            feats_max_abs_diff_in_ulps_at_scale=diff.max().item()
            / bf16_ulp(scale),
            **{f"{side}_from_f32_{stat}": getattr(d, stat)().item()
               for side, d in from_f32.items() for stat in ("max", "mean")},
            confidence_max_abs_diff=(c(conf) - cpu_out["confidence"]).abs()
            .max().item(),
            from_card_feats_confidence_max_abs_diff=(c_conf - c(conf)).abs()
            .max().item(),
            from_card_feats_normed_max_ulps=bf16_ulps(c_normed, c(normed))[
                valid].max().item())
        del enc, diff, from_f32, enc32
        # 2. NMS from the card's confidence
        c_seeds = cpu._pick_seeds(c(src), c(conf), c(mask))
        stages["nms"] = dict(seeds_equal_pairs=int(
            (c_seeds == c(seeds)).all(-1).sum()))
        # 3. the kNN from the card's seeds and normalised features
        c_knn = cpu._seed_knn(c(seeds), c(normed), c(mask))
        nf = c(normed).float()
        sf = nf.gather(1, c(seeds)[..., None].expand(-1, -1, nf.shape[-1]))
        score = torch.matmul(sf, nf.transpose(-1, -2))
        stages["knn"] = dict(
            index_agreement=(c_knn == c(knn)).float().mean().item(),
            chosen_scores_max_abs_diff=(score.gather(-1, c(knn))
                                        - score.gather(-1, c_knn)).abs()
            .max().item())
        del score
        # 4. the seed transforms from the card's neighbourhoods
        c_strans = cpu._seed_transforms(c(normed), c(sigma), c(src), c(tgt),
                                        c(knn), True)
        stages["seed_trans"] = dict(
            max_abs_diff=(c_strans - c(strans)).abs().max().item())
        # 5. the counts and fitness from the card's seed transforms; 6. the
        # winner: the argmax of that fitness against the card's
        c_counts, c_fit = cpu._seed_fitness(c(strans), c(src), c(tgt),
                                            c(mask))
        stages["counts"] = dict(
            max_abs_diff=(c_counts - c(counts)).abs().max().item())
        stages["winner"] = dict(
            fitness_max_abs_diff=(c_fit.float() - c(fit).float()).abs()
            .max().item(),
            equal_pairs=int((c_fit.argmax(-1) == c(best)).sum()))
        # 7. end to end: the card's winner among the CPU's seeds tied at the
        # CPU's largest fitness
        e_seeds = cpu._pick_seeds(cpu_args[1].float(), cpu_out["confidence"],
                                  cpu_mask.float())
        e_fit = cpu_out["seed_fitness"]
        tied = e_fit == e_fit.max(-1, keepdim=True).values
        e_win = e_seeds.gather(1, e_fit.argmax(-1)[:, None])[:, 0]
        shared = (c(seeds)[:, :, None] == e_seeds[:, None]).any(-1)
        stages["end_to_end"] = dict(
            seed_overlap=shared.float().mean().item(),
            winner_among_cpu_seeds_pairs=int(
                (e_seeds == win[:, None]).any(-1).sum()),
            same_winner_pairs=int((e_win == win).sum()),
            winner_in_cpu_ties_pairs=int(
                ((e_seeds == win[:, None]) & tied).any(-1).sum()),
            cpu_tied_seeds=tied.sum(-1).tolist())
        # the hold: the CPU's seed stage chained from the card's encoder
        # output (step 1's features, step 2's seeds)
        h_knn = cpu._seed_knn(c_seeds, c_normed, c(mask))
        h_strans = cpu._seed_transforms(c_normed, c_sigma, c(src), c(tgt),
                                        h_knn, True)
        _, h_fit = cpu._seed_fitness(h_strans, c(src), c(tgt), c(mask))
        h_win = c_seeds.gather(1, h_fit.argmax(-1)[:, None])[:, 0]
        stages["hold"] = dict(same_winner_pairs=int((h_win == win).sum()))
    seconds = time.perf_counter() - t0

    e = stages["encoder"]
    limit = ENCODER_FROM_F32_LIMIT
    lines = (
        ("1 encoder", "card vs CPU end to end: features up to "
         f"{e['feats_max_ulps']:.0f} bf16 ulps apart (median "
         f"{e['feats_median_ulps']:.0f}, share apart "
         f"{e['feats_share_apart']:.4f}; max |d| "
         f"{e['feats_max_abs_diff']:.3e}, "
         f"{e['feats_max_abs_diff_in_ulps_at_scale']:.1f} ulps at the "
         "features' scale); from the f32 encoder (same weights) the card's "
         f"max {e['card_from_f32_max']:.4e} mean {e['card_from_f32_mean']:.4e}"
         f", the CPU's max {e['cpu_from_f32_max']:.4e} mean "
         f"{e['cpu_from_f32_mean']:.4e} (limit {limit}x the CPU's); "
         f"confidence max |d| {e['confidence_max_abs_diff']:.3e}; from the "
         "card's features the CPU's confidence max |d| "
         f"{e['from_card_feats_confidence_max_abs_diff']:.3e}, normalised "
         f"features {e['from_card_feats_normed_max_ulps']:.0f} ulps"),
        ("2 NMS", "from the card's confidence: seeds equal on "
         f"{stages['nms']['seeds_equal_pairs']} of {pairs} pairs"),
        ("3 kNN", "from the card's seeds and normalised features: index "
         f"agreement {stages['knn']['index_agreement']:.6f}, chosen scores "
         f"max |d| {stages['knn']['chosen_scores_max_abs_diff']:.2e} (limit "
         "1e-5)"),
        ("4 seed_trans", "from the card's neighbourhoods: max |d| "
         f"{stages['seed_trans']['max_abs_diff']:.3e}"),
        ("5 counts", "from the card's seed_trans: max |d| "
         f"{stages['counts']['max_abs_diff']} (limit 0)"),
        ("6 winners", "the CPU's fitness from step 5's counts against the "
         "card's: max |d| "
         f"{stages['winner']['fitness_max_abs_diff']}, argmax equal on "
         f"{stages['winner']['equal_pairs']} of {pairs} pairs"),
        ("7 end to end", "NMS seeds shared "
         f"{stages['end_to_end']['seed_overlap']:.4f}, the card's winner "
         "among the CPU's seeds on "
         f"{stages['end_to_end']['winner_among_cpu_seeds_pairs']} of "
         f"{pairs} pairs and among its seeds tied at its largest fitness on "
         f"{stages['end_to_end']['winner_in_cpu_ties_pairs']} of {pairs} "
         f"pairs (tied seeds {stages['end_to_end']['cpu_tied_seeds']}); "
         f"the same winner on {stages['end_to_end']['same_winner_pairs']}"),
        ("hold", "the CPU's seed stage from the card's encoder output picks "
         f"the card's winner on {stages['hold']['same_winner_pairs']} of "
         f"{pairs} pairs (limit {pairs})"))
    for tag, text in lines:
        print(f"bf16 seed stage {tag}: {text}", flush=True)
    for stat in ("max", "mean"):
        if e[f"card_from_f32_{stat}"] > limit * e[f"cpu_from_f32_{stat}"]:
            fail(f"bf16 seed stages: the card's bf16 encoder lies farther "
                 f"from the f32 encoder ({stat}) than {limit}x the CPU's")
    if stages["nms"]["seeds_equal_pairs"] != pairs:
        fail("bf16 seed stages: NMS picks other seeds from the same "
             "confidence")
    if not stages["knn"]["chosen_scores_max_abs_diff"] <= 1e-5:
        fail("bf16 seed stages: the kNN chooses other scores from the same "
             "features")
    if stages["counts"]["max_abs_diff"] != 0:
        fail("bf16 seed stages: other counts from the same seed transforms")
    if stages["winner"]["equal_pairs"] != pairs:
        fail("bf16 seed stages: another winner from the same counts")
    if stages["hold"]["same_winner_pairs"] != pairs:
        fail("bf16 seed stages: from the card's encoder output the CPU picks "
             "another winning correspondence")
    return dict(pairs=pairs, seconds=seconds, **stages)


# -- the evaluation stack (phase 7) ------------------------------------------
#
# Fixtures written here, into a temporary directory, with full-size shapes:
# a 3DMatch scene of EVAL_FRAGMENTS fragments of EVAL_POINTS keypoints with
# EVAL_DESC-d descriptors and EVAL_FRAME_HW PNG frames (resized to 120 x 160
# on the way in), a gt.log of EVAL_PAIRS pairs; KITTI_PAIRS KITTI pairs of
# KITTI_POINTS points (the CLI keeps 12000 of each) with KITTI's camera
# frames; one 3DLoMatch pair of LOMATCH_POINTS keypoints, whose mutual
# matches pass NMS_RUN (16384), so that the registrar opens a bucket of
# LOMATCH_BUCKET and NMS runs its merge pass.
EVAL_SCENE_POINTS, EVAL_FRAGMENTS, EVAL_POINTS, EVAL_DESC = 6000, 6, N, 32
EVAL_PAIRS, EVAL_BATCH, EVAL_FRAME_HW = 8, 4, (480, 640)
KITTI_PAIRS, KITTI_POINTS = 8, 12500  # the CLI keeps 12000 of each
KITTI_FRAME_HW = (376, 1241)
LOMATCH_POINTS, LOMATCH_SCENE, LOMATCH_BUCKET = 19000, 19400, 20480
NMS_RUN = 16384  # nms_local_max.cu: past this many points a pair, a merge
SERVICE_PAIRS, SERVICE_CLIENTS, SERVICE_MAX_BATCH = 32, 4, 16
# launches per forward of the eval paths (kernels not named: none): "auto"
# at 4 x 5000 and 1 x 5000 takes the f32 cache, at 8 x 12000 and 1 x 20480
# the int8 cache; the service runs int8
_F32_CACHE = {"build_compat_cache": 1, "compat_flash_attention_cached": 12,
              **_COMMON}
_INT8_CACHE = PATHS["int8_b64"]["per_forward"]


def write_png(path, rgb):
    """An 8-bit RGB PNG, filter type 0 (the card's machine has no imaging
    package; the port's reader decodes it)."""
    import struct
    import zlib

    h, w, _ = rgb.shape
    raw = b"".join(b"\x00" + rgb[y].tobytes() for y in range(h))

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 1)) + chunk(b"IEND", b""))


def _unit_rows(x):
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _fragment(rng, world, desc, n, noise=0.1):
    """n scene points in a random frame (world = pose x), 5 mm jitter, the
    scene points' descriptors with noise; returns (pts, desc, pose)."""
    from gmf_tpu_torch.geometry.se3 import random_rotation_matrix

    idx = rng.choice(len(world), n, replace=False)
    pose = np.eye(4)
    pose[:3, :3] = random_rotation_matrix(3, 1.0, rng)
    pose[:3, 3] = rng.rand(3)
    pts = (world[idx] - pose[:3, 3]) @ pose[:3, :3]
    pts += 0.005 * rng.randn(n, 3)
    return (pts.astype(np.float32),
            _unit_rows(desc[idx] + noise * rng.randn(n, desc.shape[1])),
            pose)


def write_eval_fixtures(root):
    """The 3DMatch scene (SCENE_LIST[0]; overlap files naming the first
    scene of the train and val splits over its fragments), the KITTI
    pairs and the 3DLoMatch pair; returns their paths."""
    import os
    import pickle

    from gmf_tpu_torch.data import threedmatch

    rng = np.random.RandomState(SEED + 7)
    scene = threedmatch.SCENE_LIST[0]
    seq = os.path.join(root, scene, "seq-01")
    os.makedirs(seq)
    world = rng.rand(EVAL_SCENE_POINTS, 3) * 3.0
    desc = rng.randn(EVAL_SCENE_POINTS, EVAL_DESC)
    poses = []
    for f in range(EVAL_FRAGMENTS):
        pts, feat, pose = _fragment(rng, world, desc, EVAL_POINTS)
        base = os.path.join(seq, f"cloud_bin_{f}")
        np.savez(base + "_fcgf.npz", xyz=pts, feature=feat)
        write_png(base + "_0.png", rng.randint(0, 256, EVAL_FRAME_HW + (3,),
                                               dtype=np.uint8))
        poses.append(pose)
    pairs = [(i, j) for i in range(EVAL_FRAGMENTS)
             for j in range(i + 1, EVAL_FRAGMENTS)][:EVAL_PAIRS]
    with open(os.path.join(root, scene, "gt.log"), "w") as f:
        for i, j in pairs:  # target -> source, as 3DMatch stores it
            f.write(f"{i} {j} {EVAL_FRAGMENTS}\n")
            T_ts = np.linalg.inv(np.linalg.inv(poses[j]) @ poses[i])
            f.write("\n".join(" ".join(f"{v:.10f}" for v in row)
                              for row in T_ts) + "\n")
    overlap = os.path.join(root, "overlap")
    os.makedirs(overlap)
    splits = os.path.join(os.path.dirname(threedmatch.__file__), "splits")
    for split in ("train", "val"):
        with open(os.path.join(splits, f"{split}_3dmatch.txt")) as f:
            name = f.read().split()[0]
        with open(os.path.join(overlap, f"{name}-0.txt"), "w") as f:
            for i, j in pairs:
                f.write(f"{scene}/seq-01/cloud_bin_{i}.ply "
                        f"{scene}/seq-01/cloud_bin_{j}.ply 0.5\n")

    # KITTI: 40 x 40 x 4 m clouds, 70% of the target the source moved
    kdir = os.path.join(root, "kitti", "fcgf_test")
    os.makedirs(kdir)
    for p in range(KITTI_PAIRS):
        xyz0 = rng.rand(KITTI_POINTS, 3) * np.array([40.0, 40.0, 4.0])
        T = np.eye(4)
        T[:3, :3] = random_rotation_matrix_z(rng, 0.3)
        T[:3, 3] = rng.randn(3) * np.array([2.0, 2.0, 0.1])
        xyz1 = xyz0 @ T[:3, :3].T + T[:3, 3] + 0.02 * rng.randn(
            KITTI_POINTS, 3)
        out = rng.rand(KITTI_POINTS) < 0.3
        xyz1[out] = rng.rand(out.sum(), 3) * np.array([40.0, 40.0, 4.0])
        feat = rng.randn(KITTI_POINTS, EVAL_DESC)
        np.savez(os.path.join(kdir, f"pair_{p:06d}.npz"),
                 xyz0=xyz0.astype(np.float32), xyz1=xyz1.astype(np.float32),
                 features0=_unit_rows(feat + 0.1 * rng.randn(*feat.shape)),
                 features1=_unit_rows(feat + 0.1 * rng.randn(*feat.shape)),
                 p_image=rng.randint(0, 256, KITTI_FRAME_HW + (3,),
                                     dtype=np.uint8),
                 q_image=rng.randint(0, 256, KITTI_FRAME_HW + (3,),
                                     dtype=np.uint8),
                 gt_trans=T.astype(np.float32))

    # 3DLoMatch: one pair of two fragments of one scene
    lo = os.path.join(root, "lomatch")
    os.makedirs(lo)
    lworld = rng.rand(LOMATCH_SCENE, 3) * 3.0
    ldesc = rng.randn(LOMATCH_SCENE, EVAL_DESC)
    lposes = []
    for f in range(2):
        pts, feat, pose = _fragment(rng, lworld, ldesc, LOMATCH_POINTS,
                                    noise=0.05)
        np.savez(os.path.join(lo, f"frag_{f}_fcgf.npz"), xyz=pts,
                 feature=feat)
        write_png(os.path.join(lo, f"frag_{f}_0.png"),
                  rng.randint(0, 256, EVAL_FRAME_HW + (3,), dtype=np.uint8))
        lposes.append(pose)
    gt = np.linalg.inv(lposes[1]) @ lposes[0]
    pair_file = os.path.join(root, "3DLoMatch.pkl")
    with open(pair_file, "wb") as f:
        pickle.dump({"rot": gt[None, :3, :3], "trans": gt[None, :3, 3:4],
                     "src": np.array(["lomatch/frag_0.pth"]),
                     "tgt": np.array(["lomatch/frag_1.pth"])}, f)
    return dict(root=root, scene=scene, overlap=overlap,
                kitti=os.path.join(root, "kitti"), pair_file=pair_file)


def random_rotation_matrix_z(rng, max_angle):
    """A rotation about z by up to ``max_angle`` radians (a car's yaw)."""
    a = (rng.rand() * 2 - 1) * max_angle
    c, s = math.cos(a), math.sin(a)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def write_eval_checkpoint(dev, path):
    """The full-width model (random weights from SEED) as a port
    checkpoint, its settings recorded, as the trainer writes one."""
    from gmf_tpu_torch.models import PointDSC
    from gmf_tpu_torch.utils.checkpoint import save_checkpoint

    model = PointDSC(num_layers=12, num_channels=128, k=40, ratio=0.1,
                     device=dev, seed=SEED)
    save_checkpoint(path, model.state_dict(), config={"model": model.config})
    del model
    return path


def check_stats(name, stats, pairs, floor=0.9):
    """all_stats of ``pairs`` rows of 12 finite columns, recall >= floor."""
    if stats.shape != (pairs, 12):
        fail(f"{name}: all_stats of shape {stats.shape}, expected "
             f"({pairs}, 12)")
    if not np.isfinite(stats[:, :9]).all():
        fail(f"{name}: non-finite statistics")
    recall = float(stats[:, 0].mean())
    if recall < floor:
        fail(f"{name}: registration recall {recall} under {floor}")
    return recall


def check_launches(name, launches, per_forward, forwards):
    for k in KERNELS:
        want = per_forward.get(k, 0) * forwards
        if launches[k] != want:
            fail(f"{name}: {k} launched {launches[k]} times, expected "
                 f"{want} ({forwards} forwards)")


def run_cli(name, module, argv, pairs, per_forward, forwards, extra=None):
    """``module.main(argv)`` on the card with the launch counts reset just
    before and read just after; its all_stats, recall, launches, seconds
    and peak memory."""
    import os

    from gmf_tpu_torch.ops import _build

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    agg = module.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: _build.launches[k] for k in KERNELS}
    stats = np.load(os.path.join(argv[argv.index("--out") + 1],
                                 "all_stats.npy"))
    if not np.array_equal(stats, agg["all_stats"]):
        fail(f"{name}: all_stats.npy is not the aggregate")
    check_launches(name, launches, per_forward, forwards)
    out = dict(argv=argv[argv.index("--out") + 2:], pairs=pairs,
               recall=check_stats(name, stats, pairs), seconds=seconds,
               pairs_per_s=pairs / seconds, launches=launches,
               forwards=forwards,
               mean_model_time_s=float(stats[:, 9].mean()),
               mean_data_time_s=float(stats[:, 10].mean()),
               median_re_deg=float(np.median(stats[:, 1])),
               median_te_cm=float(np.median(stats[:, 2])),
               peak_memory_bytes=torch.cuda.max_memory_allocated(),
               **(extra or {}))
    print(f"eval {name}: " + json.dumps(
        {k: v for k, v in out.items() if k != "launches"}), flush=True)
    return out


def eval_3dmatch_phase(fix, ckpt, tmp):
    """test_3dmatch at --batch 4 --inflight 2 --workers 2 through main()
    (launches: one forward a full group, the groups by bucket as the
    host's matching gives them), then with --device-match as ``python -m``
    in a subprocess (its exit code, statistics and recall)."""
    import os

    from gmf_tpu_torch.data.collate import BUCKETS, next_bucket
    from gmf_tpu_torch.data.threedmatch import ThreeDMatchTest
    from gmf_tpu_torch.eval import test_3dmatch

    ds = ThreeDMatchTest(root=fix["root"], select_scene=fix["scene"])
    sizes = [ds[i]["corr_pos"].shape[0] for i in range(len(ds))]
    buckets = [next_bucket(n, BUCKETS) for n in sizes]
    forwards = sum(-(-buckets.count(b) // EVAL_BATCH) for b in set(buckets))
    if set(buckets) != {N}:
        fail(f"3dmatch fixture: buckets {buckets}, expected all {N}")
    base = ["--root", fix["root"], "--checkpoint", ckpt, "--scenes",
            fix["scene"]]
    out = dict(batched=run_cli(
        "3dmatch_b4", test_3dmatch,
        base + ["--out", os.path.join(tmp, "e3dm"), "--batch",
                str(EVAL_BATCH), "--inflight", "2", "--workers", "2"],
        EVAL_PAIRS, _F32_CACHE, forwards,
        extra=dict(correspondences=sizes)))
    t0 = time.perf_counter()
    dm_out = os.path.join(tmp, "e3dm_dm")
    r = subprocess.run([sys.executable, "-m", "gmf_tpu_torch.eval.test_3dmatch",
                        *base, "--out", dm_out, "--device-match"],
                       capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    if r.returncode != 0:
        fail(f"test_3dmatch --device-match exited {r.returncode}:\n"
             f"{r.stdout[-2000:]}\n{r.stderr[-4000:]}")
    stats = np.load(os.path.join(dm_out, "all_stats.npy"))
    out["device_match"] = dict(
        argv=["--device-match"], subprocess=True, seconds=seconds,
        pairs=EVAL_PAIRS, recall=check_stats("3dmatch_device_match", stats,
                                             EVAL_PAIRS),
        report=[ln for ln in r.stderr.splitlines() if "pairs" in ln][-1:])
    print("eval 3dmatch_device_match (python -m): " + json.dumps(
        out["device_match"]), flush=True)
    return out


def eval_kitti_phase(fix, ckpt, tmp):
    """test_kitti on KITTI_PAIRS pairs at 12000 correspondences, one
    batch, RANSAC on the predicted inliers and ICP."""
    import os

    from gmf_tpu_torch.eval import test_kitti

    return run_cli(
        "kitti_b8", test_kitti,
        ["--root", fix["kitti"], "--checkpoint", ckpt, "--out",
         os.path.join(tmp, "ekitti"), "--batch", str(KITTI_PAIRS),
         "--solver", "RANSAC", "--use-icp"],
        KITTI_PAIRS, _INT8_CACHE, 1)


def eval_lomatch_phase(fix, ckpt, tmp, rates):
    """test_3dlomatch --num-node all on the pair past NMS_RUN
    correspondences: the bucket LOMATCH_BUCKET (what NMS was called on),
    NMS's call there held to its plain version in every bit and timed
    (nms_check), which includes its merge pass."""
    import os

    from gmf_tpu_torch.eval import test_3dlomatch
    from gmf_tpu_torch.ops import fused_nms

    seen = []
    kernel = fused_nms.nms_local_max

    def recording(src_keypts, scores, radius):
        seen.append((src_keypts.clone(), scores.clone(), radius))
        return kernel(src_keypts, scores, radius)

    fused_nms.nms_local_max = recording
    try:
        out = run_cli(
            "3dlomatch_all", test_3dlomatch,
            ["--root", fix["root"], "--pair-file", fix["pair_file"],
             "--checkpoint", ckpt, "--out", os.path.join(tmp, "elo"),
             "--num-node", "all"], 1, _INT8_CACHE, 1)
    finally:
        fused_nms.nms_local_max = kernel
    shapes = [tuple(s.shape) for s, _, _ in seen]
    if shapes != [(1, LOMATCH_BUCKET, 3)] or LOMATCH_BUCKET <= NMS_RUN:
        fail(f"3dlomatch: NMS ran on {shapes}, expected one call on the "
             f"{LOMATCH_BUCKET} bucket, past {NMS_RUN} (the merge pass)")
    src, scores, radius = seen[0]
    if radius != 0.10:
        fail(f"3dlomatch: NMS radius {radius}")
    out["bucket"] = LOMATCH_BUCKET
    out["nms_merge_passes"] = math.ceil(math.log2(LOMATCH_BUCKET / NMS_RUN))
    out["nms"] = nms_check("3dlomatch nms", src, scores, [slice(0, 1)],
                           rates)
    print("eval 3dlomatch nms: " + json.dumps(out["nms"]), flush=True)
    return out


def train_3dmatch_phase(fix, tmp):
    """train_pointdsc --dataset 3DMatch --max-epoch 1 --steps-per-epoch 2
    --prefetch 2 on the fixtures through main(): the dense training (no
    attention kernel; the f32 kNN and the counts once a forward: one eval
    step before, two train steps, one eval step after), every metric
    finite, a snapshot written."""
    import os

    from gmf_tpu_torch.ops import _build
    from gmf_tpu_torch.train import train_pointdsc

    save = os.path.join(tmp, "train3dm")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    history = train_pointdsc.main(
        ["--dataset", "3DMatch", "--root", fix["root"], "--overlap-path",
         fix["overlap"], "--max-epoch", "1", "--steps-per-epoch", "2",
         "--prefetch", "2", "--save-dir", save])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: _build.launches[k] for k in KERNELS}
    check_launches("train_3dmatch", launches, _TRAIN_COMMON, 4)
    for kind, _, metrics in history:
        if not all(math.isfinite(v) for v in metrics.values()):
            fail(f"train_3dmatch: non-finite {kind} metrics {metrics}")
    if not os.path.exists(os.path.join(save, "model_best", "state.pt")):
        fail("train_3dmatch: no model_best snapshot")
    out = dict(seconds=seconds, forwards=4, launches=launches,
               train=history[1][2], final_eval=history[-1][2],
               peak_memory_bytes=torch.cuda.max_memory_allocated())
    print("train_3dmatch: " + json.dumps(
        {k: v for k, v in out.items() if k != "launches"}), flush=True)
    return out


def service_phase(dev):
    """RegistrationService (int8 cache, bf16 modules, max_batch 16) behind
    the full-width registrar: warm-up, then SERVICE_CLIENTS threads each
    submit their share of SERVICE_PAIRS pairs of 5000 correspondences at
    once and wait for them (latency: submit to result).
    Each flush the service dispatched is run again through register_batch
    on the same pairs: every transform and label equal (raw_b16's
    card-vs-card bound). Launches: the main path's a flush."""
    from concurrent.futures import ThreadPoolExecutor

    from gmf_tpu_torch.eval.serving import RegistrationService
    from gmf_tpu_torch.ops import _build

    reg = make_registrar(dev, compat_cache="int8")
    pairs = make_requests(SERVICE_PAIRS)[0]
    flushes = []
    dispatch = reg.dispatch_batch

    def recording(samples):
        flushes.append([dict(s) for s in samples])
        return dispatch(samples)

    with RegistrationService(reg, max_batch=SERVICE_MAX_BATCH,
                             max_wait_ms=10.0, inflight=2) as svc:
        t0 = time.perf_counter()
        svc.warmup([N])
        torch.cuda.synchronize()
        warmup_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        reg.dispatch_batch = recording  # the flushes from here on

        def client(c):
            """Submit this client's pairs, then wait for them; a
            request's latency ends when the service sets its result."""
            sent = []
            for i in range(c, SERVICE_PAIRS, SERVICE_CLIENTS):
                t, done_at = time.perf_counter(), []
                fut = svc.submit(dict(pairs[i]))
                fut.add_done_callback(
                    lambda f, d=done_at: d.append(time.perf_counter()))
                sent.append((i, t, done_at, fut))
            return [(i, (f.result(timeout=300), d)[1][0] - t, f.result())
                    for i, t, d, f in sent]

        t0 = time.perf_counter()
        with ThreadPoolExecutor(SERVICE_CLIENTS) as ex:
            done = [r for lat in ex.map(client, range(SERVICE_CLIENTS))
                    for r in lat]
        wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    reg.dispatch_batch = dispatch
    launches = {k: _build.launches[k] for k in KERNELS}
    check_launches("service", launches, _INT8_CACHE, len(flushes))
    results = {i: res for i, _, res in done}
    by_id = {id(p["corr_pos"]): i for i, p in enumerate(pairs)}
    trans_diff, label_diffs, checked = 0.0, 0, set()
    for group in flushes:
        ref = reg.register_batch([dict(s) for s in group])
        for s, (t_ref, lab_ref) in zip(group, ref):
            i = by_id[id(s["corr_pos"])]
            if i in checked:
                continue  # a pad row: a copy of a pair of the flush
            checked.add(i)
            t, lab = results[i]
            trans_diff = max(trans_diff, float(np.abs(t - t_ref).max()))
            label_diffs += int((lab != lab_ref).sum())
    ok, rot = 0, []
    for i, (t, _) in results.items():
        re_ = rot_err_deg(t, pairs[i]["gt_trans"])
        te = float(np.linalg.norm(t[:3, 3] - pairs[i]["gt_trans"][:3, 3]))
        rot.append(re_)
        ok += re_ < 15.0 and te < 0.30
    lat_ms = np.array([1e3 * s for _, s, _ in done])
    out = dict(pairs=SERVICE_PAIRS, clients=SERVICE_CLIENTS,
               max_batch=SERVICE_MAX_BATCH, flushes=len(flushes),
               flush_sizes=[len(g) for g in flushes], warmup_s=warmup_s,
               wall_s=wall, pairs_per_s=SERVICE_PAIRS / wall,
               latency_ms_p50=float(np.percentile(lat_ms, 50)),
               latency_ms_p95=float(np.percentile(lat_ms, 95)),
               latency_ms_max=float(lat_ms.max()), launches=launches,
               vs_register_batch_max_trans_diff=trans_diff,
               vs_register_batch_label_diffs=label_diffs,
               recall=f"{ok}/{len(rot)}",
               peak_memory_bytes=torch.cuda.max_memory_allocated())
    print("service: " + json.dumps(
        {k: v for k, v in out.items() if k != "launches"}), flush=True)
    if len(checked) != SERVICE_PAIRS:
        fail(f"service: {len(checked)} of {SERVICE_PAIRS} pairs dispatched")
    if trans_diff != 0.0 or label_diffs:
        fail("service: results differ from register_batch on the same "
             "pairs")
    if ok < 0.9 * len(rot):
        fail(f"service: registration recall {ok}/{len(rot)}")
    del reg
    torch.cuda.empty_cache()
    return out


def eval_phase(dev, rates, phase_done):
    """Phase 7: the evaluation stack at full width on fixtures written
    into a temporary directory (removed after)."""
    import os
    import tempfile

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        fix = write_eval_fixtures(os.path.join(tmp, "data"))
        ckpt = write_eval_checkpoint(dev, os.path.join(tmp, "ckpt"))
        phase_done("eval_fixtures")
        out["3dmatch"] = eval_3dmatch_phase(fix, ckpt, tmp)
        phase_done("eval_3dmatch")
        out["kitti"] = eval_kitti_phase(fix, ckpt, tmp)
        phase_done("eval_kitti")
        out["3dlomatch"] = eval_lomatch_phase(fix, ckpt, tmp, rates)
        phase_done("eval_3dlomatch")
        out["train_3dmatch"] = train_3dmatch_phase(fix, tmp)
        phase_done("train_3dmatch")
    torch.cuda.empty_cache()
    out["service"] = service_phase(dev)
    phase_done("service")
    return out


# -- DGR+GMF registration (phase 8) ------------------------------------------
#
# DeepGlobalRegistration.register at full width: FCGF (ResUNetBN2C 1 -> 32,
# CHANNELS 32/64/128/256, TR 64/64/64/128, conv1 7^3; 5^3 in the KITTI
# preset) and the 6-D GMF inlier net (conv1 3^6, image_dim 128, 120 x 160
# frames), random weights from SEED. Fragments are make_dgr_pair's surface
# (a bumpy heightfield, gmf_tpu_torch/data/dgr_loader.py) scaled to SIDE
# metres a side and sampled with POINTS points, 70% of them in each cloud:
# ~20,000 voxels at 3DMatch's voxel 0.05 (5.8 m) and at KITTI's 0.3
# (38 m), ~1,500 for the card-against-CPU check. No TPU kernel lies on this
# path (the gmf_tpu package computes its sparse convolutions, kernel maps,
# compacted schedules and FPFH in plain jnp), so the phase adds no row to
# the kernels line.
DGR_FULL = {"dgr_3dmatch": dict(voxel=0.05, side=5.8, points=90000),
            "dgr_kitti": dict(voxel=0.3, side=38.0, points=90000)}
DGR_SMALL = dict(voxel=0.05, side=1.6, points=6400)
DGR_TIMED = 2  # timed register() calls a scale, after one warm-up
# card against CPU, both on device maps and compacted convolutions:
# inlier weights within 1e-4 (f32 through 17 sparse convolutions, two
# fusion layers and the image encoder, summed in other orders, the card's
# index_add_ in atomic order); T within 1e-4 rad and 1e-4 m (the
# refinement's stop decisions may fall an iteration apart,
# tests/test_torch_dgr.py)
DGR_W_TOL, DGR_T_TOL = 1e-4, 1e-4
# ICP from the FPFH solve: its matches at the 0.1 m threshold are a hard
# decision, so the solves' ~1e-7 difference comes out of its 20
# iterations larger, and by how much depends on the pair. Measured on the
# H100 for SEED + 20 ... SEED + 24 (the check's pair first): 1.01e-4,
# 3.2e-7, 1.8e-5, 2.3e-7 and 4.1e-7 rad; 4.8e-5, 1.5e-7, 1.3e-5, 1.5e-7
# and 4.2e-7 m. Held to 5e-4 rad and m
DGR_ICP_T_TOL = 5e-4
# FPFH on the card and the CPU, first its parts (dgr_fpfh_flips): the
# normals within 1e-5; a neighbour kept on one device only lies within
# 1e-5 m of the radius (or of the 100th neighbour's distance); a pair's
# SPFH bin that differs lies within 1e-4 of a bin's edge, at atan2's cut
# or on the source-swap tie (within 1e-5), as
# tests/test_torch_dgr.py::_bin_flips_explained holds gmf_tpu against the
# port, and at most 0.5% of the pairs flip. Then the whole: a flip moves
# the point's own SPFH and every neighbour's FPFH row, so unit rows are
# held to the CPU tests' bound against gmf_tpu (0.05), and at most 2% of
# cloud 0's 1-NN matches in cloud 1 may move. Measured on the H100 for
# SEED + 20 ... SEED + 24: the normals within 8.3e-7, 2 neighbours apart
# (both explained), 0-18 flips of 112k-127k pairs a cloud (all
# explained), rows within 0.004-0.013, 0-9 of 1,471-1,506 matches apart
# (the limit ~30)
DGR_FPFH_NORMAL_TOL, DGR_FPFH_NBR_TOL = 1e-5, 1e-5
DGR_FPFH_EDGE, DGR_FPFH_SWAP_TIE, DGR_FPFH_FLIPS = 1e-4, 1e-5, 0.005
DGR_FPFH_TOL, DGR_FPFH_NN = 0.05, 0.02
# the tiny CLI on the card and on the CPU, with FPFH and ICP: the success
# and safeguard flags equal, rre within 0.05 deg and rte within 1e-3 m.
# With FCGF its 8-d random-weight descriptors tie in the 1-NN, which the
# two devices break apart (measured: 3 of 2,866 matches, rre 3.6 deg
# apart on garbage transforms), so there the tiny FCGF's features are
# held instead, within 1e-4
DGR_CLI_RRE_TOL, DGR_CLI_RTE_TOL = 0.05, 1e-3
DGR_TINY_FEAT_TOL = 1e-4
DGR_STAGES = ("voxelize", "pyramid_3d", "fcgf", "fpfh", "nn", "unique",
              "pyramid_6d", "inlier_net", "solve", "safeguard", "icp")


def dgr_pair(seed, side, points):
    """(xyz0, xyz1, p_image, q_image, T_gt): two 70% subsets of one
    surface, the second moved by T_gt with 2 mm noise per metre of side."""
    from gmf_tpu_torch.data.dgr_loader import heightfield
    from gmf_tpu_torch.geometry.se3 import random_rotation_matrix

    rng = np.random.RandomState(seed)
    base = heightfield(rng, points) * np.float32(side)
    n = int(0.7 * points)
    xyz0 = base[rng.choice(points, n, replace=False)]
    xyz1 = base[rng.choice(points, n, replace=False)]
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = random_rotation_matrix(3, 0.3, rng)
    T[:3, 3] = rng.rand(3) * 0.3 * side
    xyz1 = (xyz1 @ T[:3, :3].T + T[:3, 3]
            + 0.002 * side * rng.randn(n, 3)).astype(np.float32)
    images = rng.rand(2, 1, *IMAGE_HW, 3).astype(np.float32)
    return xyz0, xyz1, images[0], images[1], T


def dgr_nets(kitti=False):
    """Full-width FCGF and inlier nets' state dicts (CPU), from SEED."""
    from gmf_tpu_torch.sparse.resunet import FCGFNet, GMFInlierNet

    torch.manual_seed(SEED + (1 if kitti else 0))
    fcgf = FCGFNet(conv1_kernel_size=5 if kitti else 7)
    return fcgf.state_dict(), GMFInlierNet().state_dict()


def dgr_engine(where, nets, kitti=False, **cfg):
    from gmf_tpu_torch.models.dgr import DGRConfig, DeepGlobalRegistration
    from gmf_tpu_torch.sparse.resunet import FCGFNet

    voxel = DGR_FULL["dgr_kitti" if kitti else "dgr_3dmatch"]["voxel"]
    return DeepGlobalRegistration(
        *nets, DGRConfig(voxel_size=voxel, **cfg),
        fcgf_model=FCGFNet(conv1_kernel_size=5 if kitti else 7),
        device=where)


def rot_angle(Ra, Rb):
    """The angle (rad) between two rotations, from ||Ra - Rb||_F =
    2 sqrt(2) sin(angle / 2) (arccos of the trace loses small angles)."""
    d = np.linalg.norm(np.asarray(Ra, np.float64) - np.asarray(Rb, np.float64))
    return float(2.0 * np.arcsin(min(1.0, d / math.sqrt(8.0))))


def dgr_fpfh_flips(dev, xyz, rn, rf):
    """FPFH's parts of one cloud on the card against the CPU (bounds at
    DGR_FPFH_NORMAL_TOL): the normals; the neighbourhoods as sets, every
    neighbour one device alone keeps explained by the radius or the
    100th neighbour's distance; each pair's SPFH bins, both devices on the
    CPU's neighbourhoods with their own normals, every flip explained.
    Returns the counts."""
    from gmf_tpu_torch.ops import fpfh

    P = {w: torch.tensor(xyz, device=w) for w in (dev, "cpu")}
    n = {w: fpfh.estimate_normals(P[w], rn, 30) for w in P}
    knn = {w: [t.cpu() for t in fpfh._radius_knn(P[w], rf, 100)] for w in P}
    idx, valid, dist = knn["cpu"]
    N, k = idx.shape
    x64 = xyz.astype(np.float64)
    kept = {w: torch.where(knn[w][1], knn[w][0], -1).sort(1).values
            for w in P}
    nbr_apart = nbr_unexplained = 0
    for r in (kept["cpu"] != kept[dev]).any(1).nonzero()[:, 0].tolist():
        sets = [set(kept[w][r].tolist()) - {-1} for w in P]
        kth = (float(dist[r, -1]) if max(map(len, sets)) == k
               else math.inf)
        for q in sets[0] ^ sets[1]:
            d = float(np.linalg.norm(x64[q] - x64[r]))
            nbr_apart += 1
            nbr_unexplained += min(abs(d - rf), abs(d - kth)) >= \
                DGR_FPFH_NBR_TOL
    vals, bins = {}, {}
    for w in P:
        i = idx.to(P[w].device)
        f = fpfh._pair_features(P[w][:, None].expand(N, k, 3),
                                n[w][:, None].expand(N, k, 3), P[w][i],
                                n[w][i])
        vals[w] = [v.cpu().numpy() for v in f[:3]]
        bins[w] = [fpfh.pair_bins(v, *r).cpu().numpy()
                   for v, r in zip(f, fpfh.BIN_RANGES)]
    ij, v = idx.numpy(), valid.numpy()
    nc = n["cpu"].numpy().astype(np.float64)
    dh = x64[ij] - x64[:, None]
    dh /= np.linalg.norm(dh, axis=-1, keepdims=True)
    swap_tie = np.abs(np.abs((nc[:, None] * dh).sum(-1))
                      - np.abs((nc[ij] * dh).sum(-1)))
    flips = unexplained = 0
    for a, ba, bb, (lo, hi) in zip(vals["cpu"], bins["cpu"], bins[dev],
                                   fpfh.BIN_RANGES):
        diff = (ba != bb) & v
        pos = (a - lo) / (hi - lo) * 11
        on_edge = np.abs(pos - np.round(pos)) < DGR_FPFH_EDGE * 11 / (hi - lo)
        branch_cut = (hi == math.pi) & (np.abs(np.abs(a) - math.pi)
                                        < DGR_FPFH_EDGE)
        explained = on_edge | branch_cut | (swap_tie < DGR_FPFH_SWAP_TIE)
        flips += int(diff.sum())
        unexplained += int((diff & ~explained).sum())
    return dict(points=N, pairs=int(v.sum()),
                normal_max_abs_err=float((n["cpu"] - n[dev].cpu()).abs()
                                         .max()),
                neighbours_apart=nbr_apart,
                neighbours_unexplained=int(nbr_unexplained),
                bin_flips=flips, bin_flips_unexplained=unexplained)


def dgr_fpfh_card_vs_cpu(dev, pair):
    """FPFH of both clouds on the card and on the CPU: first its parts
    (dgr_fpfh_flips, each flip explained); then the features, unit rows
    within DGR_FPFH_TOL and at most DGR_FPFH_NN of cloud 0's 1-NN matches
    apart. Returns the card's features (CPU tensors) and the row."""
    from gmf_tpu_torch.geometry.knn import nearest_neighbor
    from gmf_tpu_torch.ops.fpfh import compute_fpfh
    from gmf_tpu_torch.sparse.voxelize import sparse_quantize

    vs = DGR_SMALL["voxel"]
    clouds = [x[sparse_quantize(x, vs)[1]] for x in pair[:2]]
    parts = [dgr_fpfh_flips(dev, x, 2 * vs, 5 * vs) for x in clouds]
    feats = [[compute_fpfh(torch.tensor(x, device=where),
                           normal_radius=2 * vs, feature_radius=5 * vs).cpu()
              for x in clouds] for where in (dev, "cpu")]
    diff = torch.cat([(a - b).abs().amax(1) for a, b in zip(*feats)])
    nn = [nearest_neighbor(*f)[0] for f in feats]
    row = dict(parts=parts, rows=len(diff),
               rows_over_1e4=int((diff > 1e-4).sum()),
               max_abs_err=float(diff.max()),
               p99_abs_err=float(diff.quantile(0.99)),
               matches=len(nn[0]), nn01_differ=int((nn[0] != nn[1]).sum()))
    print("dgr fpfh card vs cpu: " + json.dumps(row), flush=True)
    for c, p in enumerate(parts):
        if p["normal_max_abs_err"] > DGR_FPFH_NORMAL_TOL:
            fail(f"dgr fpfh cloud {c}: normals apart by "
                 f"{p['normal_max_abs_err']} > {DGR_FPFH_NORMAL_TOL}")
        if p["neighbours_unexplained"] or p["bin_flips_unexplained"]:
            fail(f"dgr fpfh cloud {c}: {p['neighbours_unexplained']} "
                 f"neighbours and {p['bin_flips_unexplained']} SPFH bins "
                 "apart between the card and the CPU, not at an edge")
        if p["bin_flips"] > DGR_FPFH_FLIPS * p["pairs"]:
            fail(f"dgr fpfh cloud {c}: {p['bin_flips']} of {p['pairs']} "
                 "pairs' bins apart")
    if row["max_abs_err"] > DGR_FPFH_TOL:
        fail(f"dgr fpfh: unit rows apart by {row['max_abs_err']} > "
             f"{DGR_FPFH_TOL} between the card and the CPU")
    if row["nn01_differ"] > DGR_FPFH_NN * row["matches"]:
        fail(f"dgr fpfh: {row['nn01_differ']} of {row['matches']} 1-NN "
             "matches apart")
    return feats[0], row


def dgr_pyramid_arrays_equal(where, got, want):
    """Every key of two pyramid dicts equal in every bit (schedules leaf
    by leaf); fails naming the first that is not."""
    def leaves(x, path):
        if isinstance(x, dict):
            for k in sorted(x):
                yield from leaves(x[k], f"{path}/{k}")
        elif isinstance(x, (tuple, list)):
            for i, v in enumerate(x):
                yield from leaves(v, f"{path}[{i}]")
        else:
            yield path, x

    a, b = dict(leaves(got, "")), dict(leaves(want, ""))
    if a.keys() != b.keys():
        fail(f"{where}: keys differ: {sorted(a.keys() ^ b.keys())}")
    for k, x in a.items():
        y = b[k]
        if isinstance(x, torch.Tensor):
            same = (x.dtype == y.dtype and x.shape == y.shape
                    and torch.equal(x.cpu(), y.cpu()))
        else:
            same = x == y
        if not same:
            fail(f"{where}: {k} differs")
    return len(a)


def dgr_pyramid_checks(dev, eng, pair, nn01):
    """At the check's pair: the card's device pyramids, 3-D (cloud 0 at
    the FCGF's conv1) and 6-D (the unique correspondences), compacted and
    not, equal in every array to the CPU's device pyramids and,
    uncompacted, to the native host builder's."""
    from gmf_tpu_torch.sparse.device_maps import build_pyramid_arrays_device
    from gmf_tpu_torch.sparse.kernel_map import build_pyramid
    from gmf_tpu_torch.sparse.resunet import pyramid_to_arrays
    from gmf_tpu_torch.sparse.voxelize import sparse_quantize

    cfg = eng.config
    c0, c1 = (eng.preprocess(x)[0] for x in pair[:2])
    uniq = sparse_quantize(np.concatenate([c0, c1[nn01]], 1).astype(
        np.float64), 1.0, return_index=False)
    row = {}
    for dim, coords, conv1, granule in (
            (3, c0, eng.fcgf.conv1_kernel_size, cfg.voxel_cap_granule),
            (6, uniq, 3, cfg.corr_cap_granule)):
        kw = dict(conv1_kernel_size=conv1, granule=granule)
        for compact in (False, True):
            got = build_pyramid_arrays_device(
                coords, 4, compact_conv=compact,
                compact_dense_frac=cfg.compact_dense_frac, device=dev, **kw)
            tag = f"dgr card vs cpu {dim}-D pyramid, compact {compact}"
            row[f"{dim}d{'_compact' if compact else ''}_arrays"] = \
                dgr_pyramid_arrays_equal(
                    tag + ", CPU's device builder", got,
                    build_pyramid_arrays_device(
                        coords, 4, compact_conv=compact,
                        compact_dense_frac=cfg.compact_dense_frac,
                        device="cpu", **kw))
            if not compact:
                dgr_pyramid_arrays_equal(
                    tag + ", native builder", got,
                    pyramid_to_arrays(build_pyramid(coords, 4, **kw), dev))
    row["voxels"] = [len(c0), len(uniq)]
    print("dgr card vs cpu pyramids equal: " + json.dumps(row), flush=True)
    return row


def dgr_card_vs_cpu(dev, nets, seed=SEED + 20):
    """register() on the card's default path (device maps, compacted
    inlier convolutions) and on the CPU with the same config (the same
    weights, the same ~1,500-voxel pair): nn01 equal, weights within
    DGR_W_TOL, used_safeguard equal, T within DGR_T_TOL (DGR_ICP_T_TOL
    with ICP); for fcgf, fpfh and fpfh with ICP. The fpfh CPU runs take
    the card's FPFH (dgr_fpfh_card_vs_cpu holds the features themselves).
    Then the pyramids at that pair (dgr_pyramid_checks)."""
    pair = dgr_pair(seed, DGR_SMALL["side"], DGR_SMALL["points"])
    card_fpfh, out = dgr_fpfh_card_vs_cpu(dev, pair)
    out = {"fpfh_features": out}
    for name, cfg in (("fcgf", {}), ("fpfh", dict(descriptor="fpfh")),
                      ("fpfh_icp", dict(descriptor="fpfh", use_icp=True))):
        res = {}
        for where in (dev, "cpu"):
            # the card's default (auto: on), the CPU's by name
            eng = dgr_engine(where, nets, **cfg, **(
                {} if where == dev else dict(device_kernel_maps=True)))
            if not (eng.config.use_device_maps(eng.device)
                    and eng.config.use_compact_conv(eng.device)):
                fail(f"dgr card vs cpu {name} ({where}): not on device "
                     "maps and compacted convolutions")
            if cfg.get("descriptor") == "fpfh" and where == "cpu":
                given = iter(card_fpfh)
                eng.fpfh_features = lambda pts: next(given)
            t0 = time.perf_counter()
            res[str(where)] = eng.register(*pair[:4])
            res[str(where) + "_s"] = time.perf_counter() - t0
        card, cpu = res[str(dev)], res["cpu"]
        nn_diff = int((card["corres"][1] != cpu["corres"][1]).sum())
        row = dict(correspondences=len(card["weights"]), nn01_differ=nn_diff,
                   weights_max_abs_err=(float(np.abs(
                       card["weights"] - cpu["weights"]).max())
                       if nn_diff == 0 else None),
                   used_safeguard=[card["used_safeguard"],
                                   cpu["used_safeguard"]],
                   rotation_err_rad=rot_angle(card["trans"][:3, :3],
                                              cpu["trans"][:3, :3]),
                   translation_err_m=float(np.abs(
                       card["trans"][:3, 3] - cpu["trans"][:3, 3]).max()),
                   card_s=res[str(dev) + "_s"], cpu_s=res["cpu_s"])
        print(f"dgr card vs cpu {name}: " + json.dumps(row), flush=True)
        if nn_diff:
            fail(f"dgr card vs cpu {name}: nn01 differs on {nn_diff} "
                 "correspondences")
        if row["weights_max_abs_err"] > DGR_W_TOL:
            fail(f"dgr card vs cpu {name}: weights differ by "
                 f"{row['weights_max_abs_err']} > {DGR_W_TOL}")
        if card["used_safeguard"] != cpu["used_safeguard"]:
            fail(f"dgr card vs cpu {name}: used_safeguard differs")
        t_tol = DGR_ICP_T_TOL if cfg.get("use_icp") else DGR_T_TOL
        if max(row["rotation_err_rad"], row["translation_err_m"]) > t_tol:
            fail(f"dgr card vs cpu {name}: T differs beyond {t_tol}")
        out[name] = row
        if name == "fcgf":
            out["pyramids"] = dgr_pyramid_checks(dev, eng, pair,
                                                 card["corres"][1])
    return out


def dgr_inlier_work(maps, inlier_ms):
    """The full-width inlier net's work on these 6-D maps (``maps``:
    ``DeepGlobalRegistration.last_inlier_maps["maps"]``): its dense-map
    products (2 K' M Cin Cout a convolution, every map entry) and gathered
    rows (4 K' M Cin bytes), the products on non-sentinel entries only,
    and, on compacted schedules, the products and gathered rows of the
    schedules' dense-tier entries and tile slots (padding included,
    ``compact.schedule_row_stats``); the rate the net ran the products of
    its own path at, and their times at the CUDA cores' f32 rate
    (F32_FLOPS; the port's GEMMs are f32 with TF32 off)."""
    C, TR = (32, 64, 128, 256), (64, 64, 64, 128)
    convs = [("conv1", 1, C[0])] + [("self_0", C[0], C[0])] * 2
    for l in (1, 2, 3):
        convs += [(f"down_{l - 1}", C[l - 1], C[l])]
        convs += [(f"self_{l}", C[l], C[l])] * 2
    tr_in = {3: C[3], 2: TR[3] + C[2], 1: TR[2] + C[1]}
    for l in (3, 2, 1):  # conv{l+1}_tr reads level l, writes level l - 1
        convs += [(f"up_{l - 1}", tr_in[l], TR[l])]
        convs += [(f"self_{l - 1}", TR[l], TR[l])] * 2

    def total(entries, per):
        return sum(per(ci, co) * entries(maps[m]) for m, ci, co in convs)

    dense = total(lambda m: m["k"] * m["m"], lambda ci, co: 2 * ci * co)
    needed = total(lambda m: m["occupancy"] * m["k"] * m["m"],
                   lambda ci, co: 2 * ci * co)
    out = dict(dense_tflop=dense / 1e12,
               gathered_gb=total(lambda m: m["k"] * m["m"],
                                 lambda ci, co: 4 * ci) / 1e9,
               non_sentinel_tflop=needed / 1e12,
               dense_f32_bound_ms=1e3 * dense / F32_FLOPS,
               non_sentinel_f32_bound_ms=1e3 * needed / F32_FLOPS)
    run = dense
    if all("dense_rows" in m for m in maps.values()):
        def rows(m):
            return m["dense_rows"] + m["compact_rows"]

        run = total(rows, lambda ci, co: 2 * ci * co)
        out.update(compact_tflop=run / 1e12,
                   compact_gathered_gb=total(rows, lambda ci, co: 4 * ci)
                   / 1e9,
                   compact_rows={name: [m["dense_rows"], m["compact_rows"]]
                                 for name, m in maps.items()},
                   compact_f32_bound_ms=1e3 * run / F32_FLOPS)
    out["achieved_tflops"] = run / (inlier_ms * 1e-3) / 1e12
    return out


def dgr_full_size(dev, name, nets, host_too=False):
    """DGR_TIMED synchronised register() calls (ICP on) after a warm-up at
    ~20,000 voxels on the default path (device maps, compacted inlier
    convolutions), and with ``host_too`` on host maps and dense
    convolutions as well, the two engines in turns; each split by stage,
    the safeguard timed on its own on the same correspondences. No map of
    the default path from a host builder, every map of the host path
    from the native one; the full-size 6-D device maps (uncompacted)
    equal to the native builder's in every array."""
    from gmf_tpu_torch.sparse import kernel_map
    from gmf_tpu_torch.sparse.device_maps import build_pyramid_arrays_device
    from gmf_tpu_torch.sparse.resunet import pyramid_to_arrays
    from gmf_tpu_torch.sparse.voxelize import sparse_quantize

    spec = DGR_FULL[name]
    kitti = name == "dgr_kitti"
    xyz0, xyz1, p, q, _ = dgr_pair(SEED + 30, spec["side"], spec["points"])
    engines = {"device": dgr_engine(dev, nets, kitti=kitti, use_icp=True)}
    if host_too:
        engines["host"] = dgr_engine(dev, nets, kitti=kitti, use_icp=True,
                                     device_kernel_maps=False)
    eng = engines["device"]
    if not (eng.config.use_device_maps(dev)
            and eng.config.use_compact_conv(dev)):
        fail(f"{name}: the card's default is not device maps and "
             "compacted convolutions")
    (c0, sel0), (c1, sel1) = (eng.preprocess(x) for x in (xyz0, xyz1))
    voxels = [len(c0), len(c1)]
    for e in engines.values():
        e.register(xyz0, xyz1, p, q)  # warm-up
        # the stage split syncs at each stage's ends; the pipeline syncs
        # at most of them anyway (the counts', 1-NN's and solve's fetches)
        e.stage_seconds = {}
    times = {k: [] for k in engines}
    peak = dict.fromkeys(engines, 0)
    builds = {k: collections.Counter() for k in engines}
    for _ in range(DGR_TIMED):
        for k, e in engines.items():
            before = collections.Counter(kernel_map.BUILDS)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            res = e.register(xyz0, xyz1, p, q)
            torch.cuda.synchronize()
            times[k].append(time.perf_counter() - t0)
            peak[k] = max(peak[k], torch.cuda.max_memory_allocated())
            builds[k] += collections.Counter(kernel_map.BUILDS) - before
            if k == "device":
                out_res = res
    if builds["device"]:
        fail(f"{name}: default-path maps from a host builder: "
             f"{dict(builds['device'])}")
    if host_too and (builds["host"].get("numpy")
                     or not builds["host"].get("native")):
        fail(f"{name}: host-path maps not all from the native builder: "
             f"{dict(builds['host'])}")
    res = out_res
    idx0, nn01 = res["corres"]
    T, w = res["trans"], res["weights"]
    if T.shape != (4, 4) or not np.isfinite(T).all():
        fail(f"{name}: T of shape {T.shape} or not finite")
    if w.shape != (len(idx0),) or not np.isfinite(w).all():
        fail(f"{name}: weights of shape {w.shape} or not finite")
    out = {}
    for k, e in engines.items():
        stages = {s: e.stage_seconds.get(s, 0.0) / DGR_TIMED
                  for s in DGR_STAGES}
        e.stage_seconds = {}
        e.safeguard_registration(xyz0[sel0], xyz1[sel1][nn01])
        stages["safeguard"] = e.stage_seconds["safeguard"]
        maps = e.last_inlier_maps
        tag = name if k == "device" else f"{name} host maps"
        print(f"{tag}: voxels {voxels}, correspondences {len(w)}, unique "
              f"6-D {maps['voxels'][0]}, register "
              f"{1e3 * np.mean(times[k]):.1f} ms (mean of {DGR_TIMED}: "
              f"{[round(1e3 * t, 1) for t in times[k]]}), peak memory "
              f"{peak[k] / 2 ** 30:.2f} GiB, used_safeguard "
              f"{res['used_safeguard']}", flush=True)
        for st in DGR_STAGES:
            print(f"{tag} stage {st}: {1e3 * stages[st]:.1f} ms", flush=True)
        for m, v in maps["maps"].items():
            print(f"{tag} 6-D map {m}: K'={v['k']} M={v['m']} occupancy "
                  f"{v['occupancy']:.4f}" + (
                      f" rows {v['dense_rows']} dense, {v['compact_rows']} "
                      "in tiles" if "dense_rows" in v else ""), flush=True)
        work = dgr_inlier_work(maps["maps"], 1e3 * stages["inlier_net"])
        print(f"{tag} inlier net work: " + json.dumps(work), flush=True)
        out[k] = dict(voxels=voxels, correspondences=len(w),
                      unique_6d=maps["voxels"][0],
                      ms_per_register=1e3 * float(np.mean(times[k])),
                      register_ms=[1e3 * t for t in times[k]],
                      stage_ms={s: 1e3 * v for s, v in stages.items()},
                      peak_memory_bytes=peak[k], maps_6d=maps["maps"],
                      inlier_work=work, builds=dict(builds[k]),
                      used_safeguard=res["used_safeguard"])
    # the full-size 6-D maps: the card's device builder against native
    uniq = sparse_quantize(np.concatenate([c0, c1[nn01]], 1).astype(
        np.float64), 1.0, return_index=False)
    kw = dict(conv1_kernel_size=3, granule=eng.config.corr_cap_granule)
    t0 = time.perf_counter()
    arrays = build_pyramid_arrays_device(uniq, 4, device=dev, **kw)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    native = kernel_map.build_pyramid(uniq, 4, **kw)
    t2 = time.perf_counter()
    n = dgr_pyramid_arrays_equal(f"{name} full-size 6-D maps", arrays,
                                 pyramid_to_arrays(native, dev))
    print(f"{name} full-size 6-D maps equal to the native builder's: {n} "
          f"arrays, {len(uniq)} voxels (device build {1e3 * (t1 - t0):.1f} "
          f"ms uncompacted, native {1e3 * (t2 - t1):.1f} ms)", flush=True)
    result = out["device"]
    result["maps_equal_native"] = dict(arrays=n, voxels=len(uniq))
    if host_too:
        result["host_maps"] = out["host"]
    return result


def write_dgr_fixtures(root, rng):
    """A 3DMatch scene of two fragments (PLY, 480 x 640 PNG frames, a
    gt.log of both directions) and a KITTI sequence 08 of three frames
    (velodyne .bin of the world within 25 m, 376 x 1241 PNG frames,
    poses 6 m apart, an identity calibration: one pair >= 10 m)."""
    import os

    from gmf_tpu_torch.data import threedmatch
    from gmf_tpu_torch.data.dgr_loader import heightfield
    from gmf_tpu_torch.data.ply import write_ply

    scene = threedmatch.SCENE_LIST[0]
    seq = os.path.join(root, "3dmatch", scene, "seq-01")
    os.makedirs(seq)
    xyz0, xyz1, _, _, T = dgr_pair(SEED + 40, 4.0, 40000)
    for f, xyz in enumerate((xyz0, xyz1)):
        write_ply(os.path.join(seq, f"cloud_bin_{f}.ply"), xyz)
        write_png(os.path.join(seq, f"cloud_bin_{f}_0.png"),
                  rng.randint(0, 256, EVAL_FRAME_HW + (3,), dtype=np.uint8))
    with open(os.path.join(root, "3dmatch", scene, "gt.log"), "w") as f:
        for (i, j), T_ij in (((0, 1), T), ((1, 0), np.linalg.inv(T))):
            f.write(f"{i} {j} 2\n")  # gt.log holds target -> source
            f.write("\n".join(" ".join(f"{v:.10f}" for v in row)
                              for row in np.linalg.inv(T_ij)) + "\n")
    kseq = os.path.join(root, "kitti", "sequences", "08")
    for sub in ("velodyne", "image_2"):
        os.makedirs(os.path.join(kseq, sub))
    os.makedirs(os.path.join(root, "kitti", "poses"))
    world = (heightfield(rng, 120000) * np.float32(60.0)
             - np.float32([18.0, 30.0, 0.0]))
    poses = []
    for t in range(3):
        pose = np.eye(4)
        pose[:3, 3] = [6.0 * t, 0.0, 0.0]
        poses.append(pose[:3, :4].ravel())
        pts = world - np.float32(pose[:3, 3])
        pts = pts[np.linalg.norm(pts[:, :2], axis=1) < 25.0]
        np.concatenate([pts, np.ones((len(pts), 1), np.float32)], 1).astype(
            np.float32).tofile(os.path.join(kseq, "velodyne", f"{t:06d}.bin"))
        write_png(os.path.join(kseq, "image_2", f"{t:06d}.png"),
                  rng.randint(0, 256, KITTI_FRAME_HW + (3,), dtype=np.uint8))
    np.savetxt(os.path.join(root, "kitti", "poses", "08.txt"),
               np.stack(poses))
    with open(os.path.join(kseq, "calib.txt"), "w") as f:
        f.write("Tr: " + " ".join(f"{v:.6f}" for v in np.eye(4)[:3].ravel())
                + "\n")
    return dict(threedmatch=os.path.join(root, "3dmatch"), scene=scene,
                kitti=os.path.join(root, "kitti"))


def dgr_cli(name, argv, pairs):
    """``test_dgr.main(argv)``: its rows must be ``pairs`` x 5, finite."""
    from gmf_tpu_torch.eval import test_dgr

    t0 = time.perf_counter()
    stats = test_dgr.main(argv)
    seconds = time.perf_counter() - t0
    if stats.shape != (pairs, 5) or not np.isfinite(stats).all():
        fail(f"test_dgr {name}: stats of shape {stats.shape}, finite "
             f"{np.isfinite(stats).all()}")
    print(f"test_dgr {name} in {seconds:.1f} s: success "
          f"{stats[:, 0].tolist()}, rre {stats[:, 1].round(3).tolist()}, "
          f"rte {stats[:, 2].round(4).tolist()}, safeguard "
          f"{stats[:, 4].tolist()}", flush=True)
    return stats, seconds


def dgr_cli_phase(dev, tmp, nets, nets_kitti):
    """test_dgr through main(argv): full width with --descriptor fpfh
    --use-icp on the card, 3DMatch and KITTI; --tiny with FPFH and ICP
    on the card and with --cpu on 3DMatch (success and safeguard flags
    equal, rre and rte within DGR_CLI_RRE_TOL and DGR_CLI_RTE_TOL); the
    tiny FCGF's features on both devices (dgr_tiny_features)."""
    import os

    from gmf_tpu_torch.eval.test_dgr import tiny_nets
    from gmf_tpu_torch.utils.checkpoint import save_checkpoint

    fix = write_dgr_fixtures(os.path.join(tmp, "dgr_data"),
                             np.random.RandomState(SEED + 50))
    ckpt = {}
    torch.manual_seed(SEED)
    tiny = tuple(net.state_dict() for net in tiny_nets())
    for tag, pair in (("full", nets), ("kitti", nets_kitti), ("tiny", tiny)):
        for net, state in zip(("fcgf", "inlier"), pair):
            ckpt[tag, net] = save_checkpoint(
                os.path.join(tmp, f"ckpt_{tag}_{net}"), state)

    def argv(tag, dataset, out, *extra):
        root = fix["kitti" if dataset == "kitti" else "threedmatch"]
        scenes = ["08"] if dataset == "kitti" else [fix["scene"]]
        return ["--root", root, "--dataset", dataset, "--scenes", *scenes,
                "--fcgf-checkpoint", ckpt[tag, "fcgf"],
                "--inlier-checkpoint", ckpt[tag, "inlier"],
                "--out", os.path.join(tmp, out), *extra]

    out = {}
    for dataset, tag, pairs in (("3dmatch", "full", 2), ("kitti", "kitti", 1)):
        stats, s = dgr_cli(f"{dataset} fpfh --use-icp", argv(
            tag, dataset, f"dgr_{dataset}", "--descriptor", "fpfh",
            "--use-icp"), pairs)
        out[dataset] = dict(seconds=s, stats=stats.tolist())
    out["tiny_fcgf_features"] = dgr_tiny_features(
        dev, fix, argv("tiny", "3dmatch", "dgr_tiny_features", "--tiny",
                       "--voxel", "0.1"))
    for name, extra in (("fpfh_icp", ("--descriptor", "fpfh", "--use-icp")),):
        runs = {where: dgr_cli(f"3dmatch --tiny {name} ({where})", argv(
            "tiny", "3dmatch", f"dgr_tiny_{name}_{where}", "--tiny",
            "--voxel", "0.1", *extra,
            *(["--cpu"] if where == "cpu" else [])), 2)
            for where in ("card", "cpu")}
        a, b = runs["card"][0], runs["cpu"][0]
        row = dict(rre_diff=float(np.abs(a[:, 1] - b[:, 1]).max()),
                   rte_diff=float(np.abs(a[:, 2] - b[:, 2]).max()),
                   card_s=runs["card"][1], cpu_s=runs["cpu"][1])
        out[f"tiny_{name}_card_vs_cpu"] = row
        print(f"test_dgr --tiny {name} card vs cpu: " + json.dumps(row),
              flush=True)
        if not np.array_equal(a[:, [0, 3, 4]], b[:, [0, 3, 4]]):
            fail(f"test_dgr --tiny {name}: success or safeguard flags "
                 "differ between the card and the CPU")
        if row["rre_diff"] > DGR_CLI_RRE_TOL or (
                row["rte_diff"] > DGR_CLI_RTE_TOL):
            fail(f"test_dgr --tiny {name}: card and CPU apart by "
                 f"{row['rre_diff']} deg, {row['rte_diff']} m")
    return out


def dgr_tiny_features(dev, fix, argv):
    """The tiny FCGF's unit features of the 3DMatch fixture's clouds on
    the card and the CPU, each engine test_dgr's own for ``argv``: within
    DGR_TINY_FEAT_TOL, and how many 1-NN matches the two devices break
    apart (8-d random-weight descriptors have near ties; reported, not
    bounded)."""
    import os

    from gmf_tpu_torch.data.ply import read_ply
    from gmf_tpu_torch.eval.test_dgr import make_engine, parse_args
    from gmf_tpu_torch.geometry.knn import nearest_neighbor

    seq = os.path.join(fix["threedmatch"], fix["scene"], "seq-01")
    clouds = [read_ply(os.path.join(seq, f"cloud_bin_{i}.ply"))["xyz"]
              for i in range(2)]
    feats = []
    for where in (dev, "cpu"):
        eng = make_engine(parse_args(argv), where)
        feats.append([torch.tensor(eng.fcgf_features(eng.preprocess(x)[0]))
                      for x in clouds])
    err = max(float((a - b).abs().max()) for a, b in zip(*feats))
    nn = [nearest_neighbor(*f)[0] for f in feats]
    row = dict(max_abs_err=err, nn01_differ=int((nn[0] != nn[1]).sum()),
               matches=len(nn[0]))
    print("test_dgr --tiny fcgf features card vs cpu: " + json.dumps(row),
          flush=True)
    if err > DGR_TINY_FEAT_TOL:
        fail(f"tiny FCGF features apart by {err} between the card and CPU")
    return row


def dgr_phase(dev, phase_done):
    """Phase 8: DGR+GMF registration at full width: the card against the
    CPU, the timed main path at 3DMatch and KITTI scale, the CLIs."""
    import tempfile

    torch.set_num_threads(8)
    nets, nets_kitti = dgr_nets(), dgr_nets(kitti=True)
    out = {"card_vs_cpu": dgr_card_vs_cpu(dev, nets)}
    phase_done("dgr_card_vs_cpu")
    out["dgr_3dmatch"] = dgr_full_size(dev, "dgr_3dmatch", nets,
                                       host_too=True)
    out["dgr_kitti"] = dgr_full_size(dev, "dgr_kitti", nets_kitti)
    phase_done("dgr_full_size")
    with tempfile.TemporaryDirectory() as tmp:
        out["cli"] = dgr_cli_phase(dev, tmp, nets, nets_kitti)
    phase_done("dgr_cli")
    torch.cuda.empty_cache()
    return out


# -- DGR+GMF training (phase 9) ----------------------------------------------
#
# WeightedProcrustesTrainer at full width (phase 8's nets from SEED, the
# FCGF frozen, the inlier net trained with SGD as dgr_3dmatch() sets it)
# on training pairs made from dgr_pair's clouds (ground-truth matches
# within 2 voxels, as make_dgr_pair's), the contrastive FCGF trainer, the
# bf16 nets and the train_dgr command line. The trainer builds its maps
# on the card as dense pruned maps (no compaction, as gmf_tpu's trainer),
# and sparse_conv's backward gathers again what its forward gathered. No
# TPU kernel lies on this path either.
DGR_TRAIN_PAIRS = 4    # pairs a step at 3DMatch scale (dgr_3dmatch's batch)
DGR_TRAIN_TIMED = 2    # timed steps, after one warm-up step
DGR_DESC_TIMED = 2     # timed descriptor pairs, after one warm-up pair
DGR_TRAIN_STAGES = ("descriptors", "pyramid_6d", "forward_backward",
                    "update")
# card against CPU, one SGD train_step of 2 pairs at DGR_SMALL: each
# pair's loss within DGR_LOSS_RTOL relative (measured 9.5e-8); each
# gradient leaf and each leaf of SGD's momentum buffer (the step's
# decayed gradient) within DGR_GRAD_TOL of its own largest entry
# (measured at most 1.9e-5), the updated parameters within it of the
# update's largest entry plus two f32 spacings of the parameter's; the
# running statistics within DGR_STATE_TOL (measured 2.2e-6). The image
# encoder is held apart: its stem's and first block's gradient is what
# is left after each train-mode batch norm takes out the channel's mean
# and its activation's share, and on the second pair the two devices
# lie 5.3e-3 apart there. Each device's encoder backward is held to the
# same backward in f64 on the CPU from the same inputs and upstream
# gradient (encoder_f64_check), which shows whose error it is: the
# CPU's f32 lies 5.3e-3 from f64, the card's 8.2e-6. So the card's
# error must stay within DGR_ENCODER_F64 x the CPU's plus 1e-5, and card
# against CPU within DGR_ENCODER_TOL. H100 80GB HBM3, 700 W
DGR_GRAD_TOL, DGR_STATE_TOL = 1e-4, 1e-4
DGR_ENCODER_TOL, DGR_ENCODER_F64 = 2e-2, 2.0
DGR_LOSS_RTOL = 1e-5
# the card's bf16 inlier logits no farther from its f32 logits than
# DGR_BF16_FACTOR x the CPU's bf16 distance
DGR_BF16_FACTOR = 1.5


def dgr_train_pair(seed, side, points, voxel):
    """A training pair (make_dgr_pair's keys) from dgr_pair's clouds:
    voxelized, the ground-truth matches within 2 voxels."""
    from gmf_tpu_torch.data.dgr_loader import get_matching_indices
    from gmf_tpu_torch.sparse.voxelize import sparse_quantize

    xyz0, xyz1, p, q, T = dgr_pair(seed, side, points)
    (c0, s0), (c1, s1) = (sparse_quantize(x, voxel) for x in (xyz0, xyz1))
    pts0, pts1 = xyz0[s0], xyz1[s1]
    return dict(pcd0=pts0, pcd1=pts1, coords0=c0, coords1=c1, T_gt=T,
                correspondences=get_matching_indices(pts0, pts1, T,
                                                     2 * voxel),
                p_image=p[0], q_image=q[0])


def dgr_modules(nets):
    """The full-width FCGF (conv1 7^3) and inlier nets with ``nets``'
    weights, on the CPU: copied for each trainer and engine of phase 9
    (a copy costs a fraction of the inlier net's 238M-entry init)."""
    from gmf_tpu_torch.sparse.resunet import FCGFNet, GMFInlierNet

    mods = (FCGFNet(conv1_kernel_size=7), GMFInlierNet())
    for net, state in zip(mods, nets):
        net.load_state_dict(state, strict=True)
    return mods


def dgr_trainer(where, mods, **cfg):
    from gmf_tpu_torch.configs.presets import dgr_3dmatch
    from gmf_tpu_torch.train.dgr_trainer import WeightedProcrustesTrainer

    return WeightedProcrustesTrainer(*map(copy.deepcopy, mods),
                                     dgr_3dmatch(**cfg), device=where)


def train_hard_decisions(p, logits, metrics, clip):
    """The loss's decisions that a last-bit difference can part: weights
    within 1e-6 of the clip, ws within 1e-3 of 10, the arccos argument
    within 1e-6 of its 1 - 1e-7 clip."""
    w = torch.sigmoid(logits[p["inv"], 0]) * p["mask"]
    cos = math.cos(math.radians(metrics["rot_err_deg"]))
    return dict(weights_near_clip=int(((w - clip).abs() < 1e-6).sum()),
                ws=metrics["ws"], ws_near_10=abs(metrics["ws"] - 10) < 1e-3,
                arccos_near_clip=abs(cos) > 1 - 1e-7 - 1e-6)


def record_pairs(trainer):
    """Each pair ``trainer`` trains on from now, read from its own calls
    (which are unchanged): its gradients (on the CPU), metrics and hard
    decisions (train_hard_decisions), a dict a pair in the list returned."""
    rows, seen = [], {}
    prep, pair_grads = trainer._prep_pair, trainer.train_pair

    def record(pair):
        seen["p"] = prep(pair)
        return seen["p"]

    def counted(pair):
        grads, metrics = pair_grads(pair)
        rows.append(dict(grads=[g.cpu() for g in grads], metrics=metrics,
                         decisions=train_hard_decisions(
                             seen["p"], seen["logits"], metrics,
                             trainer.cfg.clip_weight_thresh)))
        return grads, metrics

    trainer._prep_pair, trainer.train_pair = record, counted
    trainer.inlier.register_forward_hook(
        lambda mod, args, out: seen.__setitem__("logits", out.detach()))
    return rows


def leaf_errors(got, want):
    """{name: max |got - want| / max |want|} over matching tensors."""
    out = {}
    for k, w in want.items():
        w = w.detach().double().cpu()
        g = got[k].detach().double().cpu()
        out[k] = float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
    return out


def worst(errs):
    k = max(errs, key=errs.get)
    return [k, errs[k]]


def capture_encoder(trainer):
    """Each call of ``trainer``'s image encoder from now: its input and
    the gradient that reaches its output, a (input, gradient) pair a call
    in the list returned."""
    calls = []

    def hook(mod, args, out):
        row = [args[0].detach().cpu(), None]
        calls.append(row)
        if out.requires_grad:
            out.register_hook(lambda g: row.__setitem__(1, g.detach().cpu()))

    trainer.inlier.img_encoder.backbone.register_forward_hook(hook)
    return calls


def encoder_f64_check(dev, params, calls, in_net):
    """The image encoder's backward over ``calls`` (one pair's two frames
    and upstream gradients, from the CPU's step) from ``params``, in f32
    on the CPU and on the card and in f64 on the CPU: each f32 leaf's
    distance from f64 over the leaf's f64 scale. ``in_net``: the CPU's
    in-net encoder gradients, which the f32 CPU recompute must repeat."""
    from gmf_tpu_torch.nn.resnet import ImageEncoder

    grads = {}
    for where, dtype in (("cpu", torch.float64), ("cpu", torch.float32),
                         (str(dev), torch.float32)):
        enc = ImageEncoder(base_width=64)
        enc.load_state_dict(params, strict=False)  # train mode: no stats
        enc = enc.to(where, dtype).train()
        for x, g in calls:
            enc.backbone(x.to(where, dtype)).backward(g.to(where, dtype))
        grads[where, dtype] = {f"img_encoder.{n}": w.grad.cpu()
                               for n, w in enc.named_parameters()}
    ref = grads["cpu", torch.float64]
    cpu = leaf_errors(grads["cpu", torch.float32], ref)
    card = leaf_errors(grads[str(dev), torch.float32], ref)
    return dict(cpu=cpu, card=card,
                recompute_vs_in_net=worst(leaf_errors(
                    grads["cpu", torch.float32], in_net)))


def dgr_train_card_vs_cpu(dev, mods):
    """One SGD train_step of 2 pairs at DGR_SMALL on the card and on the
    CPU (the same weights; the CPU takes the card's 1-NN matches and
    labels, after its own descriptors are held to the card's): each
    pair's labels equal, its loss within DGR_LOSS_RTOL and its gradient
    leaves within DGR_GRAD_TOL (the image encoder's within
    DGR_ENCODER_TOL and, on the worse pair, each device's encoder
    backward held to f64: encoder_f64_check); after the step the running
    statistics, SGD's momentum buffers and the parameters as the limits
    above say. Beside them each pair's hard decisions."""
    spec = DGR_SMALL
    pairs = [dgr_train_pair(SEED + 60 + i, spec["side"], spec["points"],
                            spec["voxel"]) for i in range(2)]
    card, cpu = dgr_trainer(dev, mods), dgr_trainer("cpu", mods)
    names = [n for n, _ in card.inlier.named_parameters()]

    def is_encoder(name):
        return name.startswith("img_encoder.")

    def stats(t):
        return {k: v for k, v in t.inlier.state_dict().items()
                if "running" in k}

    gen_card, gen_cpu = card.generate_inlier_input, cpu.generate_inlier_input
    matching = []

    def take_card(pair):
        pred, ok, F0, F1 = gen_card(pair)
        cpred, cok, cF0, cF1 = gen_cpu(pair)
        feat_err = max(float((a.cpu() - b).abs().max())
                       for a, b in ((F0, cF0), (F1, cF1)))
        matching.append(dict(feature_max_abs_err=feat_err,
                             nn01_differ=int((pred != cpred).any(1).sum()),
                             labels_differ=int((ok != cok).sum())))
        return pred, ok, cF0, cF1

    cpu.generate_inlier_input = take_card
    rows = {"card": record_pairs(card), "cpu": record_pairs(cpu)}
    calls = capture_encoder(cpu)
    before = {n: w.detach().cpu().clone()
              for n, w in cpu.inlier.named_parameters()}
    seconds = {}
    for where, t in (("card", card), ("cpu", cpu)):
        t0 = time.perf_counter()
        step = t.train_step(pairs)
        seconds[where] = time.perf_counter() - t0
        if step["skipped"]:
            fail(f"dgr train card vs cpu: the {where}'s step was skipped")

    def split(errs):
        """(worst outside the image encoder, worst inside it)."""
        return [worst({k: v for k, v in errs.items() if not is_encoder(k)}),
                worst({k: v for k, v in errs.items() if is_encoder(k)})]

    per_pair = []
    for a, b in zip(rows["card"], rows["cpu"]):
        err = leaf_errors(dict(zip(names, a["grads"])),
                          dict(zip(names, b["grads"])))
        per_pair.append(dict(
            loss=[a["metrics"]["loss"], b["metrics"]["loss"]],
            loss_rel_err=abs(a["metrics"]["loss"] - b["metrics"]["loss"])
            / abs(b["metrics"]["loss"]),
            worst_grad=split(err), decisions=a["decisions"]))
    # the worse pair's encoder backward against f64
    i = max(range(len(pairs)), key=lambda j: per_pair[j]["worst_grad"][1][1])
    enc_params = {n[len("img_encoder."):]: w for n, w in before.items()
                  if is_encoder(n)}
    f64 = encoder_f64_check(
        dev, enc_params, calls[2 * i:2 * i + 2],
        {n: g for n, g in zip(names, rows["cpu"][i]["grads"])
         if is_encoder(n)})
    f64_ratio = {k: (v - 1e-5) / max(f64["cpu"][k], 1e-30)
                 for k, v in f64["card"].items()}

    def buffers(t):
        return {n: t.optimizer.state[w]["momentum_buffer"]
                for n, w in t.inlier.named_parameters()}

    buf_err = leaf_errors(buffers(card), buffers(cpu))
    param_err = {}
    for n, w in card.inlier.named_parameters():
        w_cpu = dict(cpu.inlier.named_parameters())[n].detach()
        step = float((w_cpu - before[n]).abs().max())
        ulps = 2 * float(np.spacing(np.float32(w_cpu.abs().max())))
        param_err[n] = ((float((w.detach().cpu() - w_cpu).abs().max())
                         - ulps) / max(step, 1e-30))
    row = dict(pairs=[dict(voxels=[len(p["coords0"]), len(p["coords1"])],
                           matches=len(p["correspondences"]))
                      for p in pairs],
               matching=matching, per_pair=per_pair,
               encoder_f64=dict(
                   pair=i, worst_cpu=worst(f64["cpu"]),
                   worst_card=worst(f64["card"]),
                   worst_card_over_cpu=worst(f64_ratio),
                   recompute_vs_in_net=f64["recompute_vs_in_net"]),
               worst_stats=worst(leaf_errors(stats(card), stats(cpu))),
               worst_momentum=split(buf_err), worst_params=split(param_err),
               step_s=seconds,
               limits=dict(grad=DGR_GRAD_TOL, state=DGR_STATE_TOL,
                           loss_rel=DGR_LOSS_RTOL, encoder=DGR_ENCODER_TOL,
                           encoder_f64=DGR_ENCODER_F64))
    print("dgr train card vs cpu: " + json.dumps(row), flush=True)
    if any(m["labels_differ"] for m in matching):
        fail("dgr train card vs cpu: labels differ on the same matches")
    checks = [(f"pair {j}'s gradient", r["worst_grad"])
              for j, r in enumerate(per_pair)]
    checks += [("momentum buffer", row["worst_momentum"]),
               ("updated parameter", row["worst_params"])]
    for what, (rest, enc) in checks:
        if rest[1] > DGR_GRAD_TOL or enc[1] > DGR_ENCODER_TOL:
            fail(f"dgr train card vs cpu: {what} {rest} (limit "
                 f"{DGR_GRAD_TOL}), image encoder {enc} (limit "
                 f"{DGR_ENCODER_TOL})")
    for j, r in enumerate(per_pair):
        if r["loss_rel_err"] > DGR_LOSS_RTOL:
            fail(f"dgr train card vs cpu: pair {j}'s loss apart by "
                 f"{r['loss_rel_err']} > {DGR_LOSS_RTOL}")
    if row["encoder_f64"]["worst_card_over_cpu"][1] > DGR_ENCODER_F64:
        fail("dgr train card vs cpu: the card's encoder backward "
             f"{row['encoder_f64']} farther from f64 than "
             f"{DGR_ENCODER_F64} x the CPU's")
    if row["worst_stats"][1] > DGR_STATE_TOL:
        fail(f"dgr train card vs cpu: statistics {row['worst_stats']}")
    return row


def dgr_train_3dmatch(dev, mods):
    """DGR_TRAIN_TIMED synchronised train_steps of DGR_TRAIN_PAIRS pairs
    at dgr_3dmatch's scale (~20,000 voxels a cloud) after one warm-up
    step of 2 of them: ms a step, the per-pair stage split, peak memory,
    skipped steps, the loss finite and the parameters moved."""
    spec = DGR_FULL["dgr_3dmatch"]
    t0 = time.perf_counter()
    pairs = [dgr_train_pair(SEED + 70 + i, spec["side"], spec["points"],
                            spec["voxel"]) for i in range(DGR_TRAIN_PAIRS)]
    make_s = time.perf_counter() - t0
    tr = dgr_trainer(dev, mods)
    w0 = {n: w.detach().clone() for n, w in tr.inlier.named_parameters()}
    warm = tr.train_step(pairs[:2])  # warm-up: the pair loop and the sum
    tr.stage_seconds = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, metrics = [], [warm]
    for _ in range(DGR_TRAIN_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics.append(tr.train_step(pairs))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    n = DGR_TRAIN_TIMED * DGR_TRAIN_PAIRS
    split = {s: 1e3 * tr.stage_seconds.get(s, 0.0) / (
        DGR_TRAIN_TIMED if s == "update" else n) for s in DGR_TRAIN_STAGES}
    moved = max(float((w.detach() - w0[k]).abs().max())
                for k, w in tr.inlier.named_parameters())
    skipped = sum(m["skipped"] for m in metrics)
    # the first pair's dense 6-D maps: the forward's products and the
    # gathered rows plain autograd would keep for the backward (4 K' M Cin
    # bytes a convolution); the backward runs twice the forward's products
    from gmf_tpu_torch.sparse.device_maps import build_pyramid_arrays_device

    maps = {}
    build_pyramid_arrays_device(tr._prep_pair_raw(pairs[0])["uniq"], 4,
                                conv1_kernel_size=3,
                                granule=tr.corr_cap_granule, device=dev,
                                stats=maps)
    work = dgr_inlier_work(maps["maps"], split["forward_backward"] / 3)
    work = dict(dense_forward_tflop=work["dense_tflop"],
                plain_autograd_gathers_gb=work["gathered_gb"],
                fwd_bwd_tflops=work["achieved_tflops"],
                fwd_bwd_f32_bound_ms=3 * work["dense_f32_bound_ms"],
                maps={k: [v["k"], v["m"]] for k, v in maps["maps"].items()})
    out = dict(pairs_per_step=DGR_TRAIN_PAIRS,
               voxels=[[len(p["coords0"]), len(p["coords1"])] for p in pairs],
               matches=[len(p["correspondences"]) for p in pairs],
               ms_per_step=1e3 * float(np.mean(times)),
               step_ms=[1e3 * t for t in times],
               pair_stage_ms=split, peak_memory_bytes=peak,
               skipped_steps=skipped, losses=[m.get("loss") for m in metrics],
               params_moved=moved, pair_making_s=make_s,
               applied_steps=tr.applied_steps, inlier_work=work)
    print(f"dgr_train_3dmatch: {DGR_TRAIN_PAIRS} pairs a step, voxels "
          f"{out['voxels']}, {out['ms_per_step']:.1f} ms a step (mean of "
          f"{DGR_TRAIN_TIMED}: {[round(1e3 * t, 1) for t in times]}), peak "
          f"memory {peak / 2 ** 30:.2f} GiB, skipped {skipped}, losses "
          f"{out['losses']}, largest parameter change {moved:.3g}",
          flush=True)
    for s in DGR_TRAIN_STAGES:
        print(f"dgr_train_3dmatch stage {s}: {split[s]:.1f} ms a "
              f"{'step' if s == 'update' else 'pair'}", flush=True)
    print("dgr_train_3dmatch inlier net work: " + json.dumps(work),
          flush=True)
    if skipped or not all(np.isfinite(m.get("loss", np.nan))
                          for m in metrics):
        fail(f"dgr_train_3dmatch: skipped {skipped} or loss not finite")
    if not moved > 0:
        fail("dgr_train_3dmatch: the parameters did not move")
    return out, pairs


def dgr_descriptor_3dmatch(dev, mods, pairs):
    """ContrastiveDescriptorTrainer on the full-width FCGF at the same
    scale: one warm-up pair, then DGR_DESC_TIMED timed pairs: ms a pair,
    peak memory, finite losses."""
    from gmf_tpu_torch.train.descriptor import ContrastiveDescriptorTrainer

    tr = ContrastiveDescriptorTrainer(
        copy.deepcopy(mods[0]), voxel_size=DGR_FULL["dgr_3dmatch"]["voxel"],
        granule=2048, device=dev)
    rng = np.random.RandomState(SEED)
    losses = [tr.train_pair(pairs[0], rng)["loss"]]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for pair in pairs[1:1 + DGR_DESC_TIMED]:
        t0 = time.perf_counter()
        losses.append(tr.train_pair(pair, rng)["loss"])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    out = dict(ms_per_pair=1e3 * float(np.mean(times)),
               pair_ms=[1e3 * t for t in times], peak_memory_bytes=peak,
               losses=losses)
    print(f"dgr descriptor training: {out['ms_per_pair']:.1f} ms a pair "
          f"(mean of {len(times)}), peak memory {peak / 2 ** 30:.2f} GiB, "
          f"losses {losses}", flush=True)
    if not np.isfinite(losses).all():
        fail("dgr descriptor training: loss not finite")
    return out


def dgr_bf16(dev, nets, mods):
    """bf16 nets (f32 parameters): register at dgr_3dmatch's scale with
    DGRConfig(net_dtype="bfloat16")'s nets, one warm-up and DGR_TIMED
    timed calls; then at DGR_SMALL the inlier logits on the same 6-D
    input, the card's bf16 no farther from the card's f32 than
    DGR_BF16_FACTOR x the CPU's bf16 from the CPU's f32."""
    from gmf_tpu_torch.models.dgr import DGRConfig, DeepGlobalRegistration

    voxel = DGR_FULL["dgr_3dmatch"]["voxel"]
    xyz0, xyz1, p, q, _ = dgr_pair(SEED + 30, DGR_FULL["dgr_3dmatch"]["side"],
                                   DGR_FULL["dgr_3dmatch"]["points"])
    eng = DeepGlobalRegistration(*nets, DGRConfig(
        voxel_size=voxel, net_dtype="bfloat16", use_icp=True), device=dev)
    if eng.inlier.dtype != torch.bfloat16 or eng.fcgf.dtype != torch.bfloat16:
        fail("dgr bf16: net_dtype='bfloat16' built other nets")
    eng.register(xyz0, xyz1, p, q)
    times = []
    for _ in range(DGR_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = eng.register(xyz0, xyz1, p, q)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    if not np.isfinite(res["trans"]).all():
        fail("dgr bf16 register: T not finite")
    del eng
    small = dgr_pair(SEED + 20, DGR_SMALL["side"], DGR_SMALL["points"])
    logits, corr6d = {}, None
    for where in (dev, "cpu"):
        eng = DeepGlobalRegistration(
            config=DGRConfig(voxel_size=voxel),
            fcgf_model=copy.deepcopy(mods[0]),
            inlier_model=copy.deepcopy(mods[1]), device=where)
        if corr6d is None:  # the card's f32 matches
            res = eng.register(*small[:4])
            c0, c1 = (eng.preprocess(x)[0] for x in small[:2])
            corr6d = np.concatenate([c0, c1[res["corres"][1]]], 1)
        for dtype in (torch.float32, torch.bfloat16):
            eng.inlier.set_dtype(dtype)
            with torch.no_grad():
                lg, inv = eng._inlier_logits_device(corr6d, small[2],
                                                    small[3])
            logits[str(where), dtype] = lg[inv].float().cpu()
    d_card = float((logits[str(dev), torch.bfloat16]
                    - logits[str(dev), torch.float32]).abs().max())
    d_cpu = float((logits["cpu", torch.bfloat16]
                   - logits["cpu", torch.float32]).abs().max())
    out = dict(ms_per_register=1e3 * float(np.mean(times)),
               register_ms=[1e3 * t for t in times],
               logits_bf16_vs_f32_card=d_card, logits_bf16_vs_f32_cpu=d_cpu,
               f32_card_vs_cpu=float((logits[str(dev), torch.float32]
                                      - logits["cpu", torch.float32])
                                     .abs().max()),
               limit_factor=DGR_BF16_FACTOR)
    print("dgr bf16 nets: " + json.dumps(out), flush=True)
    if not d_card <= DGR_BF16_FACTOR * d_cpu:
        fail(f"dgr bf16: the card's bf16 logits {d_card} from its f32, "
             f"over {DGR_BF16_FACTOR} x the CPU's {d_cpu}")
    return out


def dgr_train_cli(dev, tmp):
    """train_dgr --dataset synthetic --tiny on the card, 1 epoch of 2
    steps; its epoch checkpoint loads through load_dgr into an engine on
    the card that registers one pair."""
    import os

    from gmf_tpu_torch.data.dgr_loader import make_dgr_pair
    from gmf_tpu_torch.eval.test_dgr import tiny_nets
    from gmf_tpu_torch.models.dgr import DGRConfig, DeepGlobalRegistration
    from gmf_tpu_torch.train import train_dgr
    from gmf_tpu_torch.utils.checkpoint import save_checkpoint
    from gmf_tpu_torch.utils.model_io import load_dgr

    torch.manual_seed(SEED)
    fcgf_ckpt = save_checkpoint(os.path.join(tmp, "train_fcgf"),
                                tiny_nets()[0].state_dict())
    save = os.path.join(tmp, "train_dgr")
    t0 = time.perf_counter()
    train_dgr.main(["--dataset", "synthetic", "--tiny", "--max-epoch", "1",
                    "--steps-per-epoch", "2", "--save-dir", save,
                    "--fcgf-checkpoint", fcgf_ckpt])
    seconds = time.perf_counter() - t0
    fcgf, inlier = tiny_nets()
    eng = DeepGlobalRegistration(
        *load_dgr(fcgf_ckpt, os.path.join(save, "checkpoint_epoch_1")),
        DGRConfig(voxel_size=0.05, voxel_cap_granule=256,
                  corr_cap_granule=256),
        fcgf_model=fcgf, inlier_model=inlier, device=dev)
    pair = make_dgr_pair(np.random.RandomState(SEED), n_points=300,
                         image_hw=(16, 16))
    res = eng.register(pair["pcd0"], pair["pcd1"], pair["p_image"][None],
                       pair["q_image"][None])
    if not np.isfinite(res["trans"]).all():
        fail("train_dgr checkpoint: register's T not finite")
    print(f"train_dgr --tiny on the card in {seconds:.1f} s; its checkpoint "
          f"registers a pair (safeguard {res['used_safeguard']})",
          flush=True)
    return dict(seconds=seconds, used_safeguard=res["used_safeguard"])


def dgr_train_phase(dev, phase_done):
    """Phase 9: DGR+GMF training on the card: card against CPU at
    DGR_SMALL, the timed step at 3DMatch scale, the descriptor trainer,
    the bf16 nets, the training CLI and its checkpoint."""
    import tempfile

    torch.set_num_threads(8)
    t0 = time.perf_counter()
    part_s = {}

    def part(name, fn, *args):
        t = time.perf_counter()
        res = fn(*args)
        part_s[name] = time.perf_counter() - t
        print(f"phase dgr_train part {name} in {part_s[name]:.1f} s",
              flush=True)
        return res

    nets = dgr_nets()
    mods = dgr_modules(nets)
    out = {"card_vs_cpu": part("card_vs_cpu", dgr_train_card_vs_cpu, dev,
                               mods)}
    out["dgr_train_3dmatch"], pairs = part("3dmatch", dgr_train_3dmatch, dev,
                                           mods)
    out["descriptor"] = part("descriptor", dgr_descriptor_3dmatch, dev, mods,
                             pairs)
    del pairs
    out["bf16"] = part("bf16", dgr_bf16, dev, nets, mods)
    with tempfile.TemporaryDirectory() as tmp:
        out["cli"] = part("cli", dgr_train_cli, dev, tmp)
    out["seconds"] = time.perf_counter() - t0
    out["part_seconds"] = part_s
    phase_done("dgr_train")
    torch.cuda.empty_cache()
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the result JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")

    from gmf_tpu_torch.ops import _build
    from gmf_tpu_torch.utils.device import resolve_device

    # 1. the card
    card = nvidia_smi("name,power.limit")
    print(card, flush=True)
    dev = resolve_device("cuda")  # also keeps TF32 off for f32 products
    kind = torch.cuda.get_device_name(0)
    rates = Rates()
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32

    # the seconds each phase took, in the order they ran
    phase_s, mark = {}, [time.perf_counter()]

    def phase_done(name):
        now = time.perf_counter()
        phase_s[name] = now - mark[0]
        mark[0] = now
        print(f"phase {name} in {phase_s[name]:.1f} s", flush=True)

    # 2. build
    t0 = time.perf_counter()
    _build.build(verbose=True)
    _build.load()
    build_s = time.perf_counter() - t0
    print(f"kernels built in {build_s:.1f} s", flush=True)
    phase_done("build")
    # 3. kernels vs plain
    rows = kernel_phase(dev, rates)
    torch.cuda.empty_cache()
    errs, seed_rows, nms_row = main_shape_phase(dev, rates)
    rows["nms_local_max"].update({f"b{B_MAIN}_{k}": v
                                  for k, v in nms_row.items()
                                  if k not in ("tolerance", "shape")})
    for name, err in errs.items():
        rows[name][f"b{B_MAIN}_max_abs_err"] = err
    # both kNN instances, the counts and both seed-solver instances at b=64
    for name, row in seed_rows.items():
        rows[name].update({f"b{B_MAIN}_{k}": v for k, v in row.items()
                           if k != "tolerance"})
    torch.cuda.empty_cache()
    phase_done("kernels")
    core = core_phase(dev)
    core32 = core_phase(dev, torch.float32)
    print("kernel checks passed", flush=True)
    phase_done("core")

    rows_bwd, train_extra = backward_phase(dev, rates)
    rows.update(rows_bwd)
    for name, extra in train_extra.items():
        rows[name].update(extra)
    torch.cuda.empty_cache()
    phase_done("backward")

    # 3b. the attention variants and their microbenchmark
    t0 = time.perf_counter()
    rows_var, variants, var_extra = variants_phase(dev, rates)
    variants["phase_seconds"] = time.perf_counter() - t0
    print(f"variants phase in {variants['phase_seconds']:.1f} s", flush=True)
    rows.update(rows_var)
    for name, extra in var_extra.items():
        rows[name].update(extra)
    for name, modes in (("compat_flash_attention", ["stream"]),
                        ("compat_flash_attention_build", ["build"]),
                        ("compat_flash_attention_cached",
                         ["cached_int8", "cached_bf16", "cached_f32"]),
                        (VARIANT_KERNELS["v1"], ["none"])):
        rows[name]["bf16_core_checks"] = {m: core[m] for m in modes}
        rows[name]["f32_core_checks"] = {m: core32[m] for m in modes}
    for variant in ("v0", "v3", "v6"):
        rows[VARIANT_KERNELS[variant]]["f32_core_checks"] = {
            variant: core32[variant]}
    torch.cuda.empty_cache()
    phase_done("variants")

    # 4. the served paths at full width; the main path first
    paths, results, winners = {"bench_flash_variants": variants}, {}, {}
    requests8 = make_requests(B)
    for name, spec in PATHS.items():
        reqs = make_requests(B_MAIN) if spec["pairs"] == B_MAIN else requests8
        if name == "auto_b8":
            reqs = reqs[:1]
        paths[name], results[name], winners[name] = serve_path(
            name, dev, reqs, timed=name != "auto_b8")
        del reqs
        torch.cuda.empty_cache()
    # the fused solver runs a fixed count of iterations, the plain chain
    # exits early: equal at convergence. A pair has the same seed under
    # both when both picked their seeds from equal confidences and the seed
    # of the same index won; those pairs are held to the seed solver's
    # bounds, the others are counted.
    same, rot_gap, trn_gap = 0, 0.0, 0.0
    for res_f, res_x, win_f, win_x in zip(
            results["int8_fused_b8"], results["int8_b8"],
            winners["int8_fused_b8"], winners["int8_b8"]):
        for i, ((tf, _), (tx, _)) in enumerate(zip(res_f, res_x)):
            if win_f["seed"][i] != win_x["seed"][i] or not np.array_equal(
                    win_f["confidence"][i], win_x["confidence"][i]):
                continue
            same += 1
            rot_gap = max(rot_gap,
                          float(np.abs(tf[:3, :3] - tx[:3, :3]).max()))
            trn_gap = max(trn_gap, float(np.abs(tf[:3, 3] - tx[:3, 3]).max()))
    total = sum(len(r) for r in results["int8_b8"])
    print(f"seed_solver fused vs xla on {total} pairs: the same seed won "
          f"{same}, largest gap of their transforms: rotation "
          f"{rot_gap:.2e} (limit 5e-4), translation {trn_gap:.2e} (limit "
          f"5e-3); another seed won {total - same}", flush=True)
    if rot_gap > 5e-4 or trn_gap > 5e-3:
        fail("seed_solver='fused' and 'xla' disagree on a pair whose "
             "winning seed is the same")
    if same < 0.75 * total:
        fail("seed_solver='fused' and 'xla' chose different seeds on more "
             "than a quarter of the pairs")
    del results, winners
    phase_done("serve")
    paths["raw_b16"] = raw_path(dev)
    phase_done("raw_b16")

    # 4b. training at the 3DMatch configuration; the main path first
    for name in TRAIN_PATHS:
        paths[name] = train_path(name, dev)
    phase_done("train")

    # 5. f32 slice and f32 train step: kernels on the card vs plain
    # versions on the CPU
    torch.set_num_threads(8)
    slices = [f32_slice_check(dev, requests8[0], "int8",
                              num_layers=CUT_LAYERS),
              f32_slice_check(dev, requests8[0], "off",
                              num_layers=CUT_LAYERS),
              f32_slice_check(dev, requests8[0], "auto",
                              fused_attention=False)]
    phase_done("f32_slices")
    bf16_runs = bf16_request(dev, requests8[0])
    slices.append(bf16_slice_check(requests8[0], *bf16_runs))
    seed_stages = bf16_seed_stage_check(bf16_runs[0])
    del bf16_runs
    phase_done("bf16_request")
    train_checks = [train_cpu_check(dev, "auto"),
                    train_cpu_check(dev, "off", num_layers=CUT_LAYERS),
                    train_cpu_check(dev, "auto", fused_attention=False)]
    phase_done("train_checks")

    # 6. the training command line
    cli = cli_phase()
    phase_done("cli")

    # 7. the evaluation stack: the CLIs, the service, 3DMatch training
    paths["eval"] = eval_phase(dev, rates, phase_done)

    # 8. DGR+GMF registration at full width (no TPU kernel on its path)
    dgr = dgr_phase(dev, phase_done)
    for name in DGR_FULL:
        dataset = name.split("_")[1]
        paths[name] = {**dgr[name], "cli": dgr["cli"][dataset]}
    paths["dgr_3dmatch"]["card_vs_cpu"] = dgr["card_vs_cpu"]
    paths["dgr_3dmatch"]["tiny_cli_card_vs_cpu"] = {
        k: v for k, v in dgr["cli"].items() if k.startswith("tiny_")}

    # 9. DGR+GMF training, bf16 nets (no TPU kernel on this path either)
    train = dgr_train_phase(dev, phase_done)
    paths["dgr_train_3dmatch"] = {
        **train["dgr_train_3dmatch"], "card_vs_cpu": train["card_vs_cpu"],
        "descriptor": train["descriptor"], "cli": train["cli"],
        "phase_seconds": train["seconds"]}
    paths["dgr_3dmatch"]["bf16"] = train["bf16"]
    rows["nms_local_max"].update({
        f"lomatch_n{LOMATCH_BUCKET}_{k}": v
        for k, v in paths["eval"]["3dlomatch"]["nms"].items()
        if k not in ("tolerance", "shape")})

    kernels = []
    for name in KERNELS:
        r = rows[name]
        path = KERNEL_PATH[name]
        if path in TRAIN_PATHS:
            per = dict(launches_per_step=TRAIN_PATHS[path]["per_step"][name])
        elif path in PATHS:
            per = dict(launches_per_forward=PATHS[path]["per_forward"][name])
        else:
            per = dict(launches_per_stack=VARIANT_LAYERS)
        if name in ALSO_REPLACES:
            per["also_replaces"] = ALSO_REPLACES[name]
        kernels.append(dict(
            name=name, route="cuda", source=SOURCES[name],
            replaces=REPLACES[name], launches=paths[path]["launches"][name],
            **per, path=path, max_abs_err=r.pop("max_abs_err"),
            ms=r.pop("ms"),
            plain_ms=r.pop("plain_ms"), bound_ms=r.pop("bound_ms"),
            bound_by=r.pop("bound_by"),
            # one PyTorch call computes only v1's function (attention
            # without compat); none computes the others
            library_ms=r.pop("library_ms", None),
            **r))
        if kernels[-1]["launches"] < 1:
            fail(f"{name} was not launched on path {path}")
    result = {"kernels": kernels}
    main_path = paths["int8_b64"]
    train = paths["train_auto"]
    serve = {"train_ms_per_step": train["ms_per_step"],
             "train_pairs_per_s": train["pairs_per_s"],
             "train_peak_memory_bytes": train["peak_memory_bytes"],
             "train_checks": train_checks, "cli": cli,
             "registrar_ms_per_request": main_path["ms_per_request"],
             "pairs_per_s": main_path["pairs_per_s"],
             "pairs_per_request": B_MAIN, "bucket": N, "build_s": build_s,
             "peak_memory_bytes": main_path["peak_memory_bytes"],
             "paths": paths, "f32_slices": slices,
             "bf16_seed_stages": seed_stages, "card": card,
             "sm_clock_max_hz": rates.clock_hz, "phase_seconds": phase_s,
             "seed_solver_fused_vs_xla": {
                 "pairs": total, "same_seed": same,
                 "max_rotation_gap": rot_gap, "max_translation_gap": trn_gap}}
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
