"""PointDSC + GMF in PyTorch with CUDA kernels.

Counterpart of ``gmf_tpu/models/pointdsc.py`` in every mode:
``fused_attention`` on or off, every ``compat_cache``, ``seed_solver``,
``knn_topk``, ``hypo_scoring`` and ``kabsch_method``, and the ring path
(``ring_mesh``).
``testing=True`` (eval):

1. ResNet-34/8 image tokens of both frames, Fusion-1.
2. num_layers x [PointCN -> NonLocalBlock]: compat-modulated attention,
   message MLP, and Fusion-2 with LCPE added to the message. With
   ``fused_attention`` (the default here) the attention is the kernel of
   ops/fused_attention.py. The spatial-consistency matrix depends on the
   keypoints only, so it can be computed once and shared by the layers:
   ``compat_cache="int8"`` lets layer 0 build the int8 cache while it
   attends and layers 1.. stream it; ``"f32"`` and ``"bf16"`` build the
   cache before the layers; ``"off"`` rebuilds compat in every layer;
   ``"auto"`` chooses by the cache's size (``_auto_compat_cache_dtype``).
   Without it (the reference's default) the model builds the dense
   [B, N, N] compat once and every layer attends densely
   (``dense_compat_attention``: plain matmuls and softmax, as the
   reference's XLA einsums, an f32 model's products summed in f64;
   autograd gives the backward).
3. Confidence MLP; NMS seeds (ops/fused_nms.py on the fused path, the
   dense ``geometry/nms.py`` on the dense ``src_dist`` otherwise).
4. Seed kNN (``knn_topk``: ops/fused_topk.py, or a top-k over the dense
   seed distances), seed spectral matching (the plain chain with the
   batch-global early exit, or the fused fixed-count kernel of
   ops/fused_seed_solver.py under ``seed_solver="fused"``), weighted
   Kabsch per seed (``kabsch_method``).
5. Hypothesis scoring (``hypo_scoring``: ops/fused_scoring.py, or the
   dense [B, S, N] residuals); best seed by first argmax.
6. Post-refinement with the batch-global stopping rule: every pair is
   refitted while ANY pair's inlier count still changes.

``testing=False`` (the training and validation branch): the same
encoder, the feature-similarity matrix M for the spectral-matching loss,
seeds by a stable argsort of the confidence, the seed solver on the plain
chain with a fixed iteration count, no post-refinement, and
``final_labels`` = confidence. Gradients flow through the attention
(the kernels' backward, or autograd through the dense attention) and
through the gathers of features and keypoints; kNN indices and inlier
counts come from detached inputs, and compat (cache or dense) is built
without gradient, as in the reference. Batch norms follow
``self.training``, the counterpart of the JAX ``train`` flag.

Module names are the reference's torch names, the ones
``gmf_tpu/utils/convert_torch.py::convert_pointdsc`` reads, so
``utils/bridge.py`` maps flax variables onto ``state_dict`` keys one to
one. Modules run in ``dtype`` (bf16 on the card is fine); geometry from
the normalised features on is f32.

With ``ring_mesh`` (a ``parallel.Mesh``) every NonLocal layer runs
``parallel/ring_attention.py``: the tokens of each pair split over the
mesh's 'data' axis, one ring call a pair in f32, the result cast back;
nothing of compat is built, and the seeds come from the NMS kernel, as
in the reference. Every rank passes the whole batch and gets the whole
result. Run inside ``parallel.sharded(mesh)`` (the registrar and the
trainer over a mesh), each rank holds a slice of the batch: the batch
norms, the eigen solver's early exit, the refinement's stopping rule and
the compat-cache gate then see the global batch, as gmf_tpu's sharded
trace does.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from gmf_tpu_torch.geometry.kabsch import rigid_transform_3d
from gmf_tpu_torch.geometry.nms import pick_seeds_nms, topk_total_order
from gmf_tpu_torch.geometry.se3 import transform
from gmf_tpu_torch.geometry.spectral import (leading_eigenvector,
                                             leading_eigenvector_fixed)
from gmf_tpu_torch.nn.fusion import FusionLayer
from gmf_tpu_torch.nn.norm import TokenBatchNorm
from gmf_tpu_torch.nn.resnet import ImageEncoder
from gmf_tpu_torch.ops.fused_attention import (
    build_compat_cache, cache_row_stride, compat_flash_attention,
    compat_flash_attention_build)
from gmf_tpu_torch.ops.fused_nms import pick_seeds_nms_fused
from gmf_tpu_torch.ops.fused_scoring import seed_hypothesis_counts
from gmf_tpu_torch.ops.fused_seed_solver import fused_seed_weights
from gmf_tpu_torch.ops.fused_topk import MAX_K, seed_knn_topk
from gmf_tpu_torch.parallel.collectives import batch_all, batch_rows
from gmf_tpu_torch.utils.device import resolve_device


def _fusion(C: int, pe: bool) -> FusionLayer:
    return FusionLayer(dim=C, latent_dim=C, cross_heads=1,
                       cross_dim_head=C // 2, pe=pe)


def _product_f64(a, b):
    """a @ b of f32 operands summed in f64 and rounded once to f32. The
    dense attention's sums run over N = 1000-5000 keys; the card's f32
    GEMMs sum them with more rounding error than the CPU's, and with them
    the card's dense f32 train step left the leaf bounds that hold it to
    the step in f64 (chip_smoke.py ``train_cpu_check``;
    scripts/check_dense_products.py measures both)."""
    return torch.matmul(a.double(), b.double()).float()


def dense_compat_attention(q, k, v, compat, mask=None, num_heads: int = 1):
    """The reference's unfused attention (gmf_tpu/models/pointdsc.py:
    142-157): logits q k^T / sqrt(C / num_heads) times the dense compat
    [B, N, N] (the same for every head), masked keys at -1e9, softmax,
    then weight @ v; ``num_heads`` splits the C channels into heads as
    gmf_tpu's ``NonLocalBlock(num_heads=)``.

    The reference's dtype promotions: the f32 compat promotes bf16 logits,
    so the softmax runs in f32 and the message [B, N, C] is f32 (the
    caller casts it back, as flax's Dense does). With f32 q, k, v (f32
    modules, training) both products are ``_product_f64``; with bf16 ones
    they are the library's, whose f32 sums lie far inside the bf16
    rounding the message then takes. Autograd gives the backward, its
    products in f64 where the forward's are."""
    B, N, C = q.shape
    if num_heads > 1:
        q, k, v = (t.reshape(B, N, num_heads, C // num_heads).transpose(1, 2)
                   for t in (q, k, v))
        compat = compat[:, None]
    product = _product_f64 if q.dtype == torch.float32 else torch.matmul
    logits = product(q, k.transpose(-1, -2)) / q.shape[-1] ** 0.5
    logits = compat * logits
    if mask is not None:
        keys = mask.reshape(B, *[1] * (logits.dim() - 2), N)
        logits = logits.masked_fill(keys <= 0, -1e9)
    weight = torch.softmax(logits, dim=-1)
    out = product(weight, v.to(weight.dtype))
    if num_heads > 1:
        out = out.transpose(1, 2).reshape(B, N, C)
    return out


class NonLocalBlock(nn.Module):
    """Compat-modulated self-attention, message MLP, Fusion-2 injection.
    ``num_heads`` > 1 splits the dense path's attention into heads
    (gmf_tpu's option); the fused and ring paths take one head, the
    reference's, and refuse more, as gmf_tpu's do."""

    def __init__(self, num_channels: int = 128, sigma_d: float = 0.10,
                 num_heads: int = 1):
        super().__init__()
        C = num_channels
        if num_heads < 1 or C % num_heads:
            raise ValueError(f"num_heads={num_heads} does not divide the "
                             f"{C} channels")
        self.sigma_d = sigma_d
        self.num_heads = num_heads
        self.projection_q = nn.Linear(C, C)
        self.projection_k = nn.Linear(C, C)
        self.projection_v = nn.Linear(C, C)
        self.fc_message = nn.Sequential(
            nn.Linear(C, C // 2), TokenBatchNorm(C // 2, eps=1e-5), nn.ReLU(),
            nn.Linear(C // 2, C // 2), TokenBatchNorm(C // 2, eps=1e-5),
            nn.ReLU(), nn.Linear(C // 2, C))
        self.fusion_layer_2 = _fusion(C, pe=True)

    def forward(self, feat, image_feat, corr_mask, src_keypts, tgt_keypts,
                compat_cache=None, build_cache: bool = False,
                fused: bool = True, attention=None, ring_mesh=None):
        """feat [B, N, C], image_feat [B, T, C] -> [B, N, C].

        ``ring_mesh``: ring attention over that mesh, one call a pair in
        f32 (gmf_tpu/models/pointdsc.py:91-104). ``fused``: the attention
        kernel; with ``build_cache`` it also emits the int8 compat cache
        and the result is ``(out, cache)``; with ``compat_cache`` it
        streams that cache instead of rebuilding compat. Otherwise
        ``dense_compat_attention`` on ``attention``, the dense [B, N, N]
        compat."""
        q, k, v = (self.projection_q(feat), self.projection_k(feat),
                   self.projection_v(feat))
        built = None
        if self.num_heads > 1 and (fused or ring_mesh is not None):
            raise ValueError(
                f"num_heads={self.num_heads}: the fused and ring attention "
                "paths take one head (the reference's); use "
                "fused_attention=False")
        if ring_mesh is not None:
            from gmf_tpu_torch.parallel.ring_attention import (
                ring_compat_attention)

            B, N, _ = feat.shape
            mask = (torch.ones(B, N, device=feat.device) if corr_mask is None
                    else corr_mask.float())
            message = torch.stack([
                ring_compat_attention(
                    q[b].float(), k[b].float(), v[b].float(),
                    src_keypts[b].float(), tgt_keypts[b].float(), mask[b],
                    ring_mesh, sigma_d=self.sigma_d)
                for b in range(B)]).to(feat.dtype)
        elif not fused:
            message = dense_compat_attention(
                q, k, v, attention, corr_mask,
                num_heads=self.num_heads).to(feat.dtype)
        elif build_cache:
            message, built = compat_flash_attention_build(
                q, k, v, src_keypts, tgt_keypts, mask=corr_mask,
                sigma_d=self.sigma_d)
        else:
            message = compat_flash_attention(
                q, k, v, src_keypts, tgt_keypts, mask=corr_mask,
                sigma_d=self.sigma_d, compat=compat_cache)
        fused_image = self.fusion_layer_2(image_feat, queries_encoder=feat)
        out = self.fc_message(message) + fused_image
        return (out, built) if build_cache else out


class NonLocalNet(nn.Module):
    """Image fusion + num_layers x [PointCN, NonLocalBlock]."""

    def __init__(self, in_dim: int = 6, num_layers: int = 12,
                 num_channels: int = 128, sigma_d: float = 0.10):
        super().__init__()
        C = num_channels
        self.num_layers = num_layers
        self.image_encoder = ImageEncoder(base_width=C // 2)
        self.fusion_layer_1 = _fusion(C, pe=False)
        self.layer0 = nn.Linear(in_dim, C)
        self.blocks = nn.ModuleDict()
        for i in range(num_layers):
            self.blocks[f"PointCN_layer_{i}"] = nn.Sequential(
                nn.Linear(C, C), TokenBatchNorm(C, eps=1e-5), nn.ReLU())
            self.blocks[f"NonLocal_layer_{i}"] = NonLocalBlock(C, sigma_d)

    def forward(self, corr_feat, p_image, q_image, corr_mask, src_keypts,
                tgt_keypts, compat_cache=None, build_cache: bool = False,
                fused: bool = True, attention=None, ring_mesh=None):
        """corr_feat [B, N, 6], images [B, H, W, 3] -> [B, N, C].

        ``fused`` (the attention kernels): ``compat_cache`` is a
        [B, N, ld] cache that every layer streams; with ``build_cache``
        layer 0 builds the int8 cache while it attends and layers 1..
        stream it. The cache lives only inside this call, so its memory
        is free again for the seed stage. Not ``fused``: every layer
        attends densely with ``attention``, the [B, N, N] compat.
        ``ring_mesh``: every layer runs ring attention over it."""
        image_feat = self.fusion_layer_1(
            self.image_encoder.tokens(p_image),
            queries_encoder=self.image_encoder.tokens(q_image))
        feat = self.layer0(corr_feat)
        cache = compat_cache
        for i in range(self.num_layers):
            feat = self.blocks[f"PointCN_layer_{i}"](feat)
            block = self.blocks[f"NonLocal_layer_{i}"]
            if build_cache and i == 0:
                feat, cache = block(feat, image_feat, corr_mask, src_keypts,
                                    tgt_keypts, build_cache=True)
            else:
                feat = block(feat, image_feat, corr_mask, src_keypts,
                             tgt_keypts, compat_cache=cache, fused=fused,
                             attention=attention, ring_mesh=ring_mesh)
        return feat


COMPAT_CACHE_MODES = ("auto", "off", "f32", "bf16", "int8")
SEED_SOLVER_MODES = ("auto", "xla", "fused")
KNN_TOPK_MODES = ("auto", "fused", "exact", "values", "approx")
HYPO_SCORING_MODES = ("auto", "fused", "dense")
KABSCH_METHODS = ("quat", "svd")
_CACHE_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16,
                 "int8": torch.int8}

# Ceilings of the "auto" compat-cache gate, in bytes of the whole
# [B, N, ld] cache. The f32 ceiling is the reference's: take the exact
# cache where it is small. The int8 ceiling covers the three bench presets
# (64 x 5000, 8 x 12000, 2 x 30000: at most 1.8e9 bytes) and is the size
# of the largest cache whose whole forward was run on an 80 GB H100
# (PERF.md has the run and its peak memory).
AUTO_F32_CACHE_MAX_BYTES = 1.5e9
AUTO_INT8_CACHE_MAX_BYTES = 2.0e9


def _auto_compat_cache_dtype(B: int, N: int):
    """The cache type "auto" takes for B pairs of N correspondences on the
    card: f32 while that cache fits ``AUTO_F32_CACHE_MAX_BYTES``, else
    int8 while it fits ``AUTO_INT8_CACHE_MAX_BYTES``, else None (stream).

    A function of the request's shape alone, never of the memory free at
    the time, so the same request always takes the same numerics.
    """
    if B * N * cache_row_stride(N, torch.float32) * 4 <= \
            AUTO_F32_CACHE_MAX_BYTES:
        return torch.float32
    if B * N * cache_row_stride(N, torch.int8) <= AUTO_INT8_CACHE_MAX_BYTES:
        return torch.int8
    return None


class PointDSC(nn.Module):
    """PointDSC+GMF (defaults from the reference's config_3DMatch.py).

    ``fused_attention``: True (the default here) runs the attention
    kernels; False the reference's dense path: the [B, N, N] compat built
    once, dense attention in every layer (``dense_compat_attention``) and
    dense NMS on the [B, N, N] distances. The reference's default is False
    and its callers choose explicitly (its bench's train mode, the eval
    CLIs, ``--fused`` of its trainer); the port's default stays True so
    that the serving path that every earlier caller of the port relies on
    keeps the kernels, and the port's callers choose as the reference's
    do (``train/train_pointdsc.py`` trains dense without ``--fused``).
    ``compat_cache``: "auto" | "off" | "f32" | "bf16" | "int8" (module
    docstring), meaningful only with ``fused_attention``, as in the
    reference. "auto" resolves by ``_auto_compat_cache_dtype`` for CUDA
    tensors and to "off" for CPU tensors, which keeps small CPU runs on
    the exact path; a named type is taken on either device.
    ``seed_solver``: "auto" | "xla" | "fused"; "auto" and "xla" run the
    plain chain with the early-exit iteration ("xla" is the reference's
    name for it), "fused" the fixed-count kernel.
    ``knn_topk``: the seed kNN. "fused": the kernel of ops/fused_topk.py
    (its plain version for CPU tensors). "exact": ``2 - 2 <seed, key>``
    in the features' dtype (full-precision f32 for f32 features), masked
    keys at +inf, then a top-k in ``lax.top_k``'s order (ties to the
    smaller index). "values" and "approx": the reference's
    ``lax.approx_max_k``, which XLA optimises only on the TPU and which is
    an exact top-k on every other backend; here both are that, exact
    top-k values with the order of ties left free (``torch.topk``).
    "auto": "fused" when k + 1 fits the kernel's width (``MAX_K``), the
    reference's resolution on its accelerator; else "exact".
    ``hypo_scoring``: "fused" (ops/fused_scoring.py), "dense" (the [B, S,
    N] residuals, the inlier indicator in the modules' dtype before its
    mean), "auto" = "fused", as on the reference's accelerator.
    ``kabsch_method``: "quat" | "svd", for the seed Kabsch and the
    post-refinement. Unknown modes raise ValueError.
    ``ring_mesh``: a ``parallel.Mesh``; every NonLocal layer then runs
    ring attention over its 'data' axis (module docstring), which takes
    the place of ``fused_attention`` and ``compat_cache``, and N must
    divide by the ring. ``compat_cache_shards`` (>= 1): the 'data' ranks
    a batch is split over when the model runs sharded, as gmf_tpu's: the
    "auto" gate sizes the cache of ceil(B_global / compat_cache_shards)
    pairs, B_global being the local batch times the ranks of the
    ``parallel.sharded`` step in progress (the registrar and the trainer
    over a mesh set it to n_data, so the gate sees one rank's share).

    ``device`` defaults to the card and raises without one unless
    ``device="cpu"``. Weights are drawn from a ``torch.Generator`` seeded
    with ``seed``: xavier-normal where the JAX model uses ``_xavier``,
    LeCun-normal for the image encoder and fusion layers, zero biases.
    """

    def __init__(self, in_dim: int = 6, num_layers: int = 12,
                 num_channels: int = 128, num_iterations: int = 10,
                 ratio: float = 0.1, inlier_threshold: float = 0.10,
                 sigma_d: float = 0.10, k: int = 40, nms_radius: float = 0.10,
                 compat_cache: str = "auto", seed_solver: str = "auto",
                 fused_attention: bool = True, knn_topk: str = "auto",
                 hypo_scoring: str = "auto", kabsch_method: str = "quat",
                 ring_mesh=None, compat_cache_shards: int = 1,
                 dtype: torch.dtype = torch.float32, device=None,
                 seed: int = 0):
        super().__init__()
        for name, value, modes in (
                ("compat_cache", compat_cache, COMPAT_CACHE_MODES),
                ("seed_solver", seed_solver, SEED_SOLVER_MODES),
                ("knn_topk", knn_topk, KNN_TOPK_MODES),
                ("hypo_scoring", hypo_scoring, HYPO_SCORING_MODES),
                ("kabsch_method", kabsch_method, KABSCH_METHODS)):
            if value not in modes:
                raise ValueError(f"unknown {name} mode {value!r}; one of "
                                 f"{modes}")
        if int(compat_cache_shards) != compat_cache_shards or \
                compat_cache_shards < 1:
            raise ValueError(f"compat_cache_shards={compat_cache_shards!r}: "
                             "a count of 'data' ranks, at least 1")
        device = resolve_device(device)
        self.ring_mesh = ring_mesh
        self.compat_cache_shards = int(compat_cache_shards)
        self.compat_cache = compat_cache
        self.seed_solver = seed_solver
        self.fused_attention = bool(fused_attention)
        self.knn_topk = knn_topk
        self.hypo_scoring = hypo_scoring
        self.kabsch_method = kabsch_method
        self.num_iterations = num_iterations
        self.ratio = ratio
        self.inlier_threshold = inlier_threshold
        self.sigma_d = sigma_d
        self.k = k
        self.nms_radius = nms_radius
        self.sigma = nn.Parameter(torch.ones(1))
        self.encoder = NonLocalNet(in_dim, num_layers, num_channels, sigma_d)
        self.classification = nn.Sequential(
            nn.Linear(num_channels, 32), nn.ReLU(), nn.Linear(32, 32),
            nn.ReLU(), nn.Linear(32, 1))
        # the scalar settings, recorded in checkpoints (train/trainer.py)
        self.config = dict(
            in_dim=in_dim, num_layers=num_layers, num_channels=num_channels,
            num_iterations=num_iterations, ratio=ratio,
            inlier_threshold=inlier_threshold, sigma_d=sigma_d, k=k,
            nms_radius=nms_radius, compat_cache=compat_cache,
            seed_solver=seed_solver, fused_attention=self.fused_attention,
            knn_topk=knn_topk, hypo_scoring=hypo_scoring,
            kabsch_method=kabsch_method)
        self._init_weights(seed)
        self.to(device=device, dtype=dtype)
        self.eval()

    def _init_weights(self, seed: int):
        g = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for name, mod in self.named_modules():
                if not isinstance(mod, (nn.Linear, nn.Conv1d, nn.Conv2d)):
                    continue
                w = mod.weight  # [out, in / groups, *kernel]
                fan_in = w[0].numel()
                fan_out = w.shape[0] * w[0, 0].numel()
                if "fusion_layer" in name or "image_encoder" in name:
                    std = math.sqrt(1.0 / fan_in)
                else:
                    std = math.sqrt(2.0 / (fan_in + fan_out))
                w.normal_(0.0, std, generator=g)
                if mod.bias is not None:
                    mod.bias.zero_()

    @property
    def device(self):
        return self.sigma.device

    @property
    def dtype(self):
        return self.sigma.dtype

    @property
    def seed_dtype(self):
        """The dtype of the normalised features and of the seed stage's
        roundings: the modules' (bf16 or f32), as in the reference; f64
        modules keep f32 there, as the geometry does."""
        return (self.dtype if self.dtype in (torch.bfloat16, torch.float32)
                else torch.float32)

    def forward(self, corr_pos, src_keypts, tgt_keypts, p_image, q_image,
                testing: bool = False, corr_mask=None):
        """corr_pos [B, N, 6], keypoints [B, N, 3], images [B, H, W, 3]
        (NHWC), corr_mask optional [B, N]. Returns final_trans [B, 4, 4],
        final_labels [B, N], M ([B, N, N], None when testing), seed_trans,
        seed_fitness, confidence. ``testing=True`` runs without gradient."""
        if testing:
            with torch.no_grad():
                return self._forward(corr_pos, src_keypts, tgt_keypts,
                                     p_image, q_image, True, corr_mask)
        return self._forward(corr_pos, src_keypts, tgt_keypts, p_image,
                             q_image, False, corr_mask)

    def _forward(self, corr_pos, src_keypts, tgt_keypts, p_image, q_image,
                 testing, corr_mask):
        B, N, _ = corr_pos.shape
        src = src_keypts.float()
        tgt = tgt_keypts.float()
        mask = None if corr_mask is None else corr_mask.float()
        src_dist = compat = None
        if self.ring_mesh is None and not self.fused_attention:
            src_dist, compat = self._dense_compat(src, tgt)
        feats = self._encode(corr_pos, src, tgt, p_image, q_image, mask,
                             testing, compat)
        normed, sigma, confidence = self._seed_features(feats)

        M = None
        if not testing:
            # feature-similarity matrix, the spectral-matching loss's input
            M = torch.matmul(normed, normed.transpose(-1, -2))
            M = torch.clamp(1.0 - (1.0 - M) / sigma ** 2, 0.0, 1.0)
            M = M * (1.0 - torch.eye(N, dtype=M.dtype, device=M.device))

        seeds = self._pick_seeds(src, confidence, mask, testing, src_dist)
        del src_dist, compat  # [B, N, N] each: free them for the seed stage
        seed_trans, seed_fitness, final_trans, final_labels = (
            self._seed_trans_from_knn(normed, sigma, src, tgt, mask,
                                      self._seed_knn(seeds, normed, mask),
                                      testing))
        if testing:
            final_trans = self._post_refinement(final_trans, src, tgt, mask)
        else:
            final_labels = confidence
        return {
            "final_trans": final_trans,
            "final_labels": final_labels,
            "M": M,
            "seed_trans": seed_trans,
            "seed_fitness": seed_fitness,
            "confidence": confidence,
        }

    def _encode(self, corr_pos, src, tgt, p_image, q_image, mask, testing,
                compat=None):
        """The encoder's output [B, N, C] in the modules' dtype (src, tgt
        f32; mask f32 or None): with this request's compat cache under
        ``fused_attention``, else with the dense compat ``compat`` (built
        here when None); under ``ring_mesh`` with neither."""
        cache, build_cache = None, False
        ring = self.ring_mesh is not None
        if self.fused_attention and not ring:
            with torch.no_grad():  # compat is data, as in the reference
                cache, build_cache = self._build_compat_cache(src, tgt,
                                                              testing)
        elif compat is None and not ring:
            compat = self._dense_compat(src, tgt)[1]
        return self.encoder(corr_pos.to(self.dtype), p_image.to(self.dtype),
                            q_image.to(self.dtype), mask, src, tgt,
                            compat_cache=cache, build_cache=build_cache,
                            fused=self.fused_attention and not ring,
                            attention=compat, ring_mesh=self.ring_mesh)

    def _dense_compat(self, src, tgt):
        """The dense path's (src_dist, compat), [B, N, N] f32 each, without
        gradient (gmf_tpu/models/pointdsc.py:407-421): compat = max(0,
        1 - (|s_i - s_j| - |t_i - t_j|)^2 / sigma_d^2), sigma_d rounded to
        the modules' dtype and squared in it, as the reference (:386)."""
        sigma_spat = torch.tensor(self.sigma_d, dtype=self.seed_dtype)
        with torch.no_grad():
            src_dist = torch.linalg.vector_norm(src[:, :, None] - src[:, None],
                                                dim=-1)
            tgt_dist = torch.linalg.vector_norm(tgt[:, :, None] - tgt[:, None],
                                                dim=-1)
            compat = torch.clamp(
                1.0 - (src_dist - tgt_dist) ** 2 / float(sigma_spat ** 2),
                min=0.0)
        return src_dist, compat

    def _build_compat_cache(self, src, tgt, testing: bool = True):
        """Resolve ``compat_cache`` for this request: ``(cache,
        build_cache)``. In test mode an int8 cache is not built here:
        layer 0 of the encoder builds it while it attends (``build_cache``
        True; that kernel has no backward). Other caches, and the int8
        cache in the train branch, are built now; "off" gives ``(None,
        False)``."""
        B, N, _ = src.shape
        if self.compat_cache == "off":
            return None, False
        if self.compat_cache == "auto":
            dtype = (None if src.device.type == "cpu"
                     else self.auto_cache_dtype(B, N))
            if dtype is None:
                return None, False
        else:
            dtype = _CACHE_DTYPES[self.compat_cache]
        if dtype == torch.int8 and testing:
            return None, True
        return build_compat_cache(src, tgt, self.sigma_d, dtype), False

    def auto_cache_dtype(self, B: int, N: int):
        """The card's "auto" cache type for a local batch of B pairs: the
        gate of ceil(B_global / compat_cache_shards) pairs, B_global the
        batch of the ``parallel.sharded`` step in progress (B outside
        one), as gmf_tpu's trace, which sees the global batch, divides it
        (gmf_tpu/models/pointdsc.py:526-531); never divided twice."""
        share = -(-batch_rows(B) // self.compat_cache_shards)
        return _auto_compat_cache_dtype(share, N)

    # The seed stage, one method a step, so that a caller can run each step
    # on its own inputs (chip_smoke.py compares the card's with the CPU's).

    def _seed_features(self, feats):
        """The encoder output [B, N, C] -> (normalised features, sigma,
        confidence [B, N] f32). In seed_dtype, as the reference: under bf16
        modules the kNN, feat_M and M see bf16 features."""
        f = feats.to(self.seed_dtype)
        normed = f / torch.sqrt((f * f).sum(-1, keepdim=True) + 1e-12)
        sigma = self.sigma.to(self.seed_dtype)
        confidence = self.classification(feats)[..., 0].float()
        return normed, sigma, confidence

    def _pick_seeds(self, src, confidence, mask, testing: bool = True,
                    src_dist=None):
        """Seed indices [B, max(N * ratio, 1)]: NMS on the confidence in
        test mode (the dense form on ``src_dist`` [B, N, N] where the
        dense path gives it, else the kernel), a stable argsort of it in
        the train branch."""
        num_seeds = max(int(src.shape[1] * self.ratio), 1)
        if testing and src_dist is not None:
            return pick_seeds_nms(src_dist, confidence.detach(),
                                  self.nms_radius, num_seeds, mask=mask)
        if testing:
            return pick_seeds_nms_fused(src, confidence, self.nms_radius,
                                        num_seeds, mask=mask)
        ranked = confidence.detach()
        if mask is not None:
            ranked = torch.where(mask > 0, ranked,
                                 torch.full_like(ranked, -math.inf))
        # stable, as jnp.argsort: ties keep their index order
        return torch.argsort(-ranked, dim=-1, stable=True)[:, :num_seeds]

    def _knn_mode(self, k: int) -> str:
        """``knn_topk`` with "auto" resolved (class docstring)."""
        if self.knn_topk != "auto":
            return self.knn_topk
        return "fused" if k + 1 <= MAX_K else "exact"

    def _seed_knn(self, seeds, feats, mask):
        """Seed-row kNN [B, S, k] int64 on detached features, by
        ``knn_topk``; column 0, the seed itself, dropped."""
        B, N, C = feats.shape
        k = min(self.k, N - 1)
        plain = feats.detach()
        seed_feats = torch.gather(plain, 1, seeds[..., None].expand(-1, -1, C))
        mode = self._knn_mode(k)
        if mode == "fused":
            knn_idx, _ = seed_knn_topk(seed_feats, plain, k + 1, mask=mask)
            return knn_idx[..., 1:].long()
        # the reference's einsum: products exact in f32, rounded to the
        # features' dtype (:591-594)
        score = torch.matmul(seed_feats.float(),
                             plain.float().transpose(-1, -2)).to(plain.dtype)
        dist = 2.0 - 2.0 * score
        if mask is not None:
            dist = dist.masked_fill(mask[:, None, :] <= 0, math.inf)
        if mode == "exact":
            knn_idx = topk_total_order(-dist.float(), k + 1)
        else:  # "values", "approx": exact top-k values, ties in any order
            knn_idx = torch.topk(-dist.float(), k + 1, dim=-1).indices
        return knn_idx[..., 1:].long()

    def _seed_trans_from_knn(self, feats, sigma, src, tgt, mask, knn_idx,
                             testing):
        """Seed-local spectral matching and weighted Kabsch
        (``_seed_transforms``), scoring (``_seed_fitness``), the best
        seed's transform and its labels."""
        rows = torch.arange(feats.shape[0], device=feats.device)
        seed_trans = self._seed_transforms(feats, sigma, src, tgt, knn_idx,
                                           testing)
        if self.hypo_scoring == "dense":
            fitness, L2 = self._dense_fitness(seed_trans, src, tgt, mask)
            best = fitness.argmax(-1)
            final_trans = seed_trans[rows, best]
            final_L2 = L2[rows, best]  # the best seed's row (:773-775)
        else:  # "fused" and "auto"
            _, fitness = self._seed_fitness(seed_trans, src, tgt, mask)
            best = fitness.argmax(-1)
            final_trans = seed_trans[rows, best]
            final_L2 = torch.linalg.vector_norm(
                transform(src, final_trans) - tgt, dim=-1)
        labels = (final_L2 < self.inlier_threshold).float()
        if mask is not None:
            labels = labels * mask
        return seed_trans, fitness, final_trans, labels

    def _seed_transforms(self, feats, sigma, src, tgt, knn_idx, testing):
        """Seed-local spectral matching and the weighted Kabsch: [B, S, 4,
        4] f32. The train branch always takes the plain chain with the
        fixed iteration count: the fused solver and the early exit are
        eval-only, as in the reference."""
        B, N, C = feats.shape
        S, k = knn_idx.shape[1:]
        rows = (knn_idx + (torch.arange(B, device=feats.device) * N)[
            :, None, None]).reshape(-1)
        knn_feats = feats.reshape(B * N, C)[rows].reshape(B, S, k, C)
        src_knn = src.reshape(B * N, 3)[rows].reshape(B, S, k, 3)
        tgt_knn = tgt.reshape(B * N, 3)[rows].reshape(B, S, k, 3)

        if self.seed_solver == "fused" and testing:
            weight = fused_seed_weights(knn_feats, src_knn, tgt_knn,
                                        sigma.float(), self.sigma_d,
                                        num_iters=self.num_iterations)
        else:
            # feat_M in the modules' dtype; sigma_d rounded to it and
            # squared in it, then the f32 spatial term: the reference's
            # promotions (gmf_tpu/models/pointdsc.py:621,670-682)
            feat_M = torch.matmul(knn_feats, knn_feats.transpose(-1, -2))
            feat_M = torch.clamp(1.0 - (1.0 - feat_M) / sigma ** 2, min=0.0)
            sigma_spat = torch.tensor(self.sigma_d, dtype=sigma.dtype)
            src_d = torch.linalg.vector_norm(
                src_knn[:, :, :, None] - src_knn[:, :, None], dim=-1)
            tgt_d = torch.linalg.vector_norm(
                tgt_knn[:, :, :, None] - tgt_knn[:, :, None], dim=-1)
            spatial_M = torch.clamp(
                1.0 - (src_d - tgt_d) ** 2 / (sigma_spat ** 2).float(),
                min=0.0)
            total_M = feat_M * spatial_M * (
                1.0 - torch.eye(k, device=feats.device))
            eig = leading_eigenvector if testing else \
                leading_eigenvector_fixed
            weight = eig(total_M.reshape(B * S, k, k),
                         num_iters=self.num_iterations)
            weight = weight.reshape(B, S, k)
            weight = weight / (weight.sum(-1, keepdim=True) + 1e-6)
        return rigid_transform_3d(
            src_knn.reshape(B * S, k, 3), tgt_knn.reshape(B * S, k, 3),
            weight.reshape(B * S, k),
            method=self.kabsch_method).reshape(B, S, 4, 4)

    def _seed_fitness(self, seed_trans, src, tgt, mask):
        """(inlier counts [B, S] int32, fitness [B, S] in seed_dtype)."""
        N = src.shape[1]
        counts = seed_hypothesis_counts(seed_trans.detach(), src, tgt,
                                        self.inlier_threshold, mask=mask)
        # the f32 ratio rounded to the modules' dtype before the argmax, as
        # the reference (:734,741-744): under bf16 near counts tie and the
        # first maximum (the lowest seed index) wins, as jnp.argmax
        if mask is None:
            fitness = counts.float() / N
        else:
            fitness = counts.float() / (mask.sum(-1)[:, None] + 1e-6)
        return counts, fitness.to(self.seed_dtype)

    def _dense_fitness(self, seed_trans, src, tgt, mask):
        """``hypo_scoring="dense"`` (gmf_tpu/models/pointdsc.py:753-767):
        the [B, S, N] residuals of every seed transform and the fitness
        [B, S], the inlier indicator in the modules' dtype before its
        mean, as the reference (:760). Without a mask the fitness is the
        f32 mean rounded to that dtype (jnp.mean of bf16 sums in f32);
        with one, the masked sum over the mask's, f32. Returns (fitness,
        residuals)."""
        pred = torch.matmul(src[:, None], seed_trans[:, :, :3, :3].transpose(
            -1, -2)) + seed_trans[:, :, None, :3, 3]
        L2 = torch.linalg.vector_norm(pred - tgt[:, None], dim=-1)
        inlier = (L2 < self.inlier_threshold).to(self.seed_dtype)
        if mask is None:
            return inlier.float().mean(-1).to(self.seed_dtype), L2
        inlier = inlier * mask[:, None, :]
        return inlier.sum(-1) / (mask.sum(-1)[:, None] + 1e-6), L2

    def _post_refinement(self, trans, src, tgt, mask):
        """Up to 20 weighted refits with weights inlier/(1+(d/tau)^2); the
        loop stops when NO pair's inlier count changed, and while any did,
        every pair is refitted."""
        tau = 0.10 if self.inlier_threshold == 0.10 else 1.2
        prev = torch.zeros(trans.shape[0], dtype=torch.int32,
                           device=trans.device)
        for _ in range(20):
            L2 = torch.linalg.vector_norm(transform(src, trans) - tgt, dim=-1)
            # in the modules' dtype, as the reference (:802-805): without a
            # mask a bf16 count is rounded to bf16 (the f32 mask promotes)
            inlier = (L2 < tau).to(self.seed_dtype)
            if mask is not None:
                inlier = inlier * mask
            num = inlier.sum(-1).int()
            # the batch's rule: a sharded batch stops when no rank's did
            if batch_all(not bool(((num - prev).abs() >= 1).any())):
                break
            w = inlier * (1.0 / (1.0 + (L2 / tau) ** 2))
            trans = rigid_transform_3d(src, tgt, w,
                                       method=self.kabsch_method)
            prev = num
        return trans
