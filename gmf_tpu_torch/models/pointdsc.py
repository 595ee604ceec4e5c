"""PointDSC + GMF in PyTorch with CUDA kernels.

Counterpart of ``gmf_tpu/models/pointdsc.py`` on its fused path
(``fused_attention=True, knn_topk="fused", hypo_scoring="fused"``, every
``compat_cache`` and ``seed_solver`` mode). ``testing=True`` (eval):

1. ResNet-34/8 image tokens of both frames, Fusion-1.
2. num_layers x [PointCN -> NonLocalBlock]: compat-modulated attention
   (ops/fused_attention.py), message MLP, and Fusion-2 with LCPE added to
   the message. The spatial-consistency matrix depends on the keypoints
   only, so it can be computed once and shared by the layers:
   ``compat_cache="int8"`` lets layer 0 build the int8 cache while it
   attends and layers 1.. stream it; ``"f32"`` and ``"bf16"`` build the
   cache before the layers; ``"off"`` rebuilds compat in every layer;
   ``"auto"`` chooses by the cache's size (``_auto_compat_cache_dtype``).
3. Confidence MLP; NMS seeds (ops/fused_nms.py).
4. Seed kNN (ops/fused_topk.py), seed spectral matching (the plain chain
   with the batch-global early exit, or the fused fixed-count kernel of
   ops/fused_seed_solver.py under ``seed_solver="fused"``),
   Horn-quaternion Kabsch per seed.
5. Hypothesis scoring (ops/fused_scoring.py); best seed by first argmax.
6. Post-refinement with the batch-global stopping rule: every pair is
   refitted while ANY pair's inlier count still changes.

``testing=False`` (the training and validation branch): the same
encoder, the feature-similarity matrix M for the spectral-matching loss,
seeds by a stable argsort of the confidence, the seed solver on the plain
chain with a fixed iteration count, no post-refinement, and
``final_labels`` = confidence. Gradients flow through the attention
kernels' backward (ops/fused_attention.py) and through the gathers of
features and keypoints; kNN indices and inlier counts come from their
kernels on detached inputs, and the compat cache is built without
gradient, as in the reference. Batch norms follow ``self.training``, the
counterpart of the JAX ``train`` flag.

Module names are the reference's torch names, the ones
``gmf_tpu/utils/convert_torch.py::convert_pointdsc`` reads, so
``utils/bridge.py`` maps flax variables onto ``state_dict`` keys one to
one. Modules run in ``dtype`` (bf16 on the card is fine); geometry from
the normalised features on is f32. The dense unfused attention is not
ported yet.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from gmf_tpu_torch.geometry.kabsch import rigid_transform_3d
from gmf_tpu_torch.geometry.se3 import transform
from gmf_tpu_torch.geometry.spectral import (leading_eigenvector,
                                             leading_eigenvector_fixed)
from gmf_tpu_torch.nn.fusion import FusionLayer
from gmf_tpu_torch.nn.norm import BatchNorm1d
from gmf_tpu_torch.nn.resnet import ImageEncoder
from gmf_tpu_torch.ops.fused_attention import (
    build_compat_cache, cache_row_stride, compat_flash_attention,
    compat_flash_attention_build)
from gmf_tpu_torch.ops.fused_nms import pick_seeds_nms_fused
from gmf_tpu_torch.ops.fused_scoring import seed_hypothesis_counts
from gmf_tpu_torch.ops.fused_seed_solver import fused_seed_weights
from gmf_tpu_torch.ops.fused_topk import seed_knn_topk
from gmf_tpu_torch.utils.device import resolve_device


class TokenBatchNorm(BatchNorm1d):
    """BatchNorm1d over the channel axis of [..., C] tokens, with flax's
    running statistics (``nn/norm.py``)."""

    def forward(self, x):
        return super().forward(x.reshape(-1, x.shape[-1])).reshape(x.shape)


def _fusion(C: int, pe: bool) -> FusionLayer:
    return FusionLayer(dim=C, latent_dim=C, cross_heads=1,
                       cross_dim_head=C // 2, pe=pe)


class NonLocalBlock(nn.Module):
    """Compat-modulated self-attention, message MLP, Fusion-2 injection."""

    def __init__(self, num_channels: int = 128, sigma_d: float = 0.10):
        super().__init__()
        C = num_channels
        self.sigma_d = sigma_d
        self.projection_q = nn.Linear(C, C)
        self.projection_k = nn.Linear(C, C)
        self.projection_v = nn.Linear(C, C)
        self.fc_message = nn.Sequential(
            nn.Linear(C, C // 2), TokenBatchNorm(C // 2, eps=1e-5), nn.ReLU(),
            nn.Linear(C // 2, C // 2), TokenBatchNorm(C // 2, eps=1e-5),
            nn.ReLU(), nn.Linear(C // 2, C))
        self.fusion_layer_2 = _fusion(C, pe=True)

    def forward(self, feat, image_feat, corr_mask, src_keypts, tgt_keypts,
                compat_cache=None, build_cache: bool = False):
        """feat [B, N, C], image_feat [B, T, C] -> [B, N, C]; with
        ``build_cache`` the attention also emits the int8 compat cache
        and the result is ``(out, cache)``. With ``compat_cache`` the
        attention streams that cache instead of rebuilding compat."""
        q, k, v = (self.projection_q(feat), self.projection_k(feat),
                   self.projection_v(feat))
        built = None
        if build_cache:
            message, built = compat_flash_attention_build(
                q, k, v, src_keypts, tgt_keypts, mask=corr_mask,
                sigma_d=self.sigma_d)
        else:
            message = compat_flash_attention(
                q, k, v, src_keypts, tgt_keypts, mask=corr_mask,
                sigma_d=self.sigma_d, compat=compat_cache)
        fused = self.fusion_layer_2(image_feat, queries_encoder=feat)
        out = self.fc_message(message) + fused
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
                tgt_keypts, compat_cache=None, build_cache: bool = False):
        """corr_feat [B, N, 6], images [B, H, W, 3] -> [B, N, C].

        ``compat_cache``: a [B, N, ld] cache that every layer streams.
        ``build_cache``: layer 0 builds the int8 cache while it attends
        and layers 1.. stream it. The cache lives only inside this call,
        so its memory is free again for the seed stage."""
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
                             tgt_keypts, compat_cache=cache)
        return feat


COMPAT_CACHE_MODES = ("auto", "off", "f32", "bf16", "int8")
SEED_SOLVER_MODES = ("auto", "xla", "fused")
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

    ``compat_cache``: "auto" | "off" | "f32" | "bf16" | "int8" (module
    docstring). "auto" resolves by ``_auto_compat_cache_dtype`` for CUDA
    tensors and to "off" for CPU tensors, which keeps small CPU runs on
    the exact path; a named type is taken on either device.
    ``seed_solver``: "auto" | "xla" | "fused"; "auto" and "xla" run the
    plain chain with the early-exit iteration ("xla" is the reference's
    name for it), "fused" the fixed-count kernel.

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
                 dtype: torch.dtype = torch.float32, device=None,
                 seed: int = 0):
        super().__init__()
        if compat_cache not in COMPAT_CACHE_MODES:
            raise ValueError(f"unknown compat_cache mode {compat_cache!r}")
        if seed_solver not in SEED_SOLVER_MODES:
            raise ValueError(f"unknown seed_solver mode {seed_solver!r}")
        device = resolve_device(device)
        self.compat_cache = compat_cache
        self.seed_solver = seed_solver
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
            seed_solver=seed_solver)
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
        feats = self._encode(corr_pos, src, tgt, p_image, q_image, mask,
                             testing)
        normed, sigma, confidence = self._seed_features(feats)

        M = None
        if not testing:
            # feature-similarity matrix, the spectral-matching loss's input
            M = torch.matmul(normed, normed.transpose(-1, -2))
            M = torch.clamp(1.0 - (1.0 - M) / sigma ** 2, 0.0, 1.0)
            M = M * (1.0 - torch.eye(N, dtype=M.dtype, device=M.device))

        seeds = self._pick_seeds(src, confidence, mask, testing)
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

    def _encode(self, corr_pos, src, tgt, p_image, q_image, mask, testing):
        """The encoder's output [B, N, C] in the modules' dtype, with this
        request's compat cache (src, tgt f32; mask f32 or None)."""
        with torch.no_grad():  # compat is data, as in the reference
            cache, build_cache = self._build_compat_cache(src, tgt, testing)
        return self.encoder(corr_pos.to(self.dtype), p_image.to(self.dtype),
                            q_image.to(self.dtype), mask, src, tgt,
                            compat_cache=cache, build_cache=build_cache)

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
                     else _auto_compat_cache_dtype(B, N))
            if dtype is None:
                return None, False
        else:
            dtype = _CACHE_DTYPES[self.compat_cache]
        if dtype == torch.int8 and testing:
            return None, True
        return build_compat_cache(src, tgt, self.sigma_d, dtype), False

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

    def _pick_seeds(self, src, confidence, mask, testing: bool = True):
        """Seed indices [B, max(N * ratio, 1)]: NMS on the confidence in
        test mode, a stable argsort of it in the train branch."""
        num_seeds = max(int(src.shape[1] * self.ratio), 1)
        if testing:
            return pick_seeds_nms_fused(src, confidence, self.nms_radius,
                                        num_seeds, mask=mask)
        ranked = confidence.detach()
        if mask is not None:
            ranked = torch.where(mask > 0, ranked,
                                 torch.full_like(ranked, -math.inf))
        # stable, as jnp.argsort: ties keep their index order
        return torch.argsort(-ranked, dim=-1, stable=True)[:, :num_seeds]

    def _seed_knn(self, seeds, feats, mask):
        """Seed-row kNN [B, S, k] int64 (fused kernel on detached features;
        column 0, the seed itself, dropped)."""
        B, N, C = feats.shape
        k = min(self.k, N - 1)
        plain = feats.detach()
        seed_feats = torch.gather(plain, 1, seeds[..., None].expand(-1, -1, C))
        knn_idx, _ = seed_knn_topk(seed_feats, plain, k + 1, mask=mask)
        return knn_idx[..., 1:].long()

    def _seed_trans_from_knn(self, feats, sigma, src, tgt, mask, knn_idx,
                             testing):
        """Seed-local spectral matching and weighted Kabsch
        (``_seed_transforms``), scoring (``_seed_fitness``), the best
        seed's transform and its labels."""
        B = feats.shape[0]
        seed_trans = self._seed_transforms(feats, sigma, src, tgt, knn_idx,
                                           testing)
        _, fitness = self._seed_fitness(seed_trans, src, tgt, mask)
        best = fitness.argmax(-1)
        final_trans = seed_trans[torch.arange(B, device=feats.device), best]
        final_L2 = torch.linalg.vector_norm(transform(src, final_trans) - tgt,
                                            dim=-1)
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
            weight.reshape(B * S, k)).reshape(B, S, 4, 4)

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
            if not bool(((num - prev).abs() >= 1).any()):
                break
            w = inlier * (1.0 / (1.0 + (L2 / tau) ** 2))
            trans = rigid_transform_3d(src, tgt, w)
            prev = num
        return trans
