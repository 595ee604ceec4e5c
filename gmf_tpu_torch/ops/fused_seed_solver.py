"""Fused seed-local spectral matching: CUDA kernel and its plain version.

Counterpart of ``gmf_tpu/ops/fused_seed_solver.py``, batched over pairs.
Every seed's k gathered neighbours give one weight vector:

    feat_M[i,j]    = max(0, 1 - (1 - <f_i, f_j>) / sigma^2)           [k, k]
    spatial_M[i,j] = max(0, 1 - (|s_i-s_j| - |t_i-t_j|)^2 / sigma_d^2)
    M = feat_M * spatial_M * (1 - I)
    v = num_iters power iterations on M from the all-ones vector
    w = v / (sum(v) + 1e-6)

``fused_seed_weights`` launches ``csrc/fused_seed_weights.cu`` on CUDA
tensors (one warp per seed, the Gram on the tensor cores, M in shared
memory, no [*, k, k] tensor in device memory) and uses
``fused_seed_weights_plain`` only for CPU tensors. The iteration count is
fixed: the model's default chain exits early on a batch-global test
instead, and the two agree at convergence only. All accumulation is f32
whatever the feature type; f32 features reach the tensor cores as three
bf16 terms each (the kernel's header). Forward only.
"""

from __future__ import annotations

import torch

from gmf_tpu_torch.geometry.kabsch import rigid_transform_3d
from gmf_tpu_torch.geometry.spectral import leading_eigenvector_fixed
from gmf_tpu_torch.ops import _build

KERNEL = "fused_seed_weights"
MAX_K = 128  # the kernel's largest neighbourhood (csrc/fused_seed_weights.cu)


def _as_sigma(sigma, device):
    return torch.as_tensor(sigma, dtype=torch.float32,
                           device=device).reshape(1)


def fused_seed_weights_plain(knn_features, src_knn, tgt_knn, sigma,
                             sigma_d: float, num_iters: int = 10):
    """Plain version: the dense chain with [B, S, k, k] tensors and the
    fixed-count iteration, f32."""
    f = knn_features.float()
    return weights_from_gram(torch.matmul(f, f.transpose(-1, -2)), src_knn,
                             tgt_knn, sigma, sigma_d, num_iters)


def weights_from_gram(gram, src_knn, tgt_knn, sigma, sigma_d: float,
                      num_iters: int = 10):
    """The plain chain from the features' Gram [..., k, k] on: feat_M,
    spatial_M, M, the fixed-count iteration and the sum normalisation. In
    f32, or in f64 all through for an f64 Gram (an exact reference)."""
    dtype = torch.promote_types(gram.dtype, torch.float32)
    src_knn, tgt_knn = src_knn.to(dtype), tgt_knn.to(dtype)
    k = gram.shape[-1]
    sig = _as_sigma(sigma, gram.device).to(dtype)
    feat_M = torch.clamp(1.0 - (1.0 - gram) / sig ** 2, min=0.0)
    src_d = torch.linalg.vector_norm(
        src_knn[..., :, None, :] - src_knn[..., None, :, :], dim=-1)
    tgt_d = torch.linalg.vector_norm(
        tgt_knn[..., :, None, :] - tgt_knn[..., None, :, :], dim=-1)
    spatial_M = torch.clamp(1.0 - (src_d - tgt_d) ** 2 / sigma_d ** 2,
                            min=0.0)
    total_M = feat_M * spatial_M * (1.0 - torch.eye(k, device=gram.device))
    w = leading_eigenvector_fixed(total_M, num_iters=num_iters)
    return w / (w.sum(-1, keepdim=True) + 1e-6)


def fused_seed_weights(knn_features, src_knn, tgt_knn, sigma,
                       sigma_d: float, num_iters: int = 10):
    """Per-seed spectral-matching weights.

    knn_features: [B, S, k, C] gathered (normalised) features, f32 or
    bf16; src_knn, tgt_knn: [B, S, k, 3] gathered keypoints; sigma: the
    learned feature sigma (a 1-element tensor or a float); sigma_d: the
    spatial sigma. Returns [B, S, k] f32, sum-normalised per seed.
    """
    if knn_features.device.type == "cpu":
        return fused_seed_weights_plain(knn_features, src_knn, tgt_knn,
                                        sigma, sigma_d, num_iters)
    if knn_features.device.type != "cuda":
        raise ValueError(
            f"{KERNEL}: unsupported device {knn_features.device}")
    if knn_features.dim() != 4:
        raise ValueError(f"{KERNEL}: knn_features must be [B, S, k, C]")
    B, S, k, C = knn_features.shape
    if knn_features.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{KERNEL}: features must be f32 or bf16, got "
                        f"{knn_features.dtype}")
    if src_knn.shape != (B, S, k, 3) or tgt_knn.shape != (B, S, k, 3):
        raise ValueError(f"{KERNEL}: neighbour keypoints must be "
                         "[B, S, k, 3]")
    if k > MAX_K:
        raise ValueError(f"{KERNEL}: k={k} above the kernel's {MAX_K}")
    feats = knn_features.contiguous()
    src = src_knn.float().contiguous()
    tgt = tgt_knn.float().contiguous()
    sig = _as_sigma(sigma, feats.device)
    out = torch.empty(B, S, k, dtype=torch.float32, device=feats.device)
    if out.numel() == 0:
        return out
    code = _build.load().gmf_fused_seed_weights(
        feats.data_ptr(), src.data_ptr(), tgt.data_ptr(), sig.data_ptr(),
        out.data_ptr(), B * S, k, C, int(feats.dtype == torch.bfloat16),
        float(sigma_d) ** 2, int(num_iters), _build.stream_of(feats))
    _build.check(code, KERNEL)
    return out


def fused_seed_transforms(knn_features, src_knn, tgt_knn, sigma,
                          sigma_d: float, num_iters: int = 10):
    """Seed transforms from gathered neighbourhoods: ``fused_seed_weights``
    then the weighted Horn-quaternion Kabsch. [B, S, k, .] -> [B, S, 4, 4]
    f32."""
    w = fused_seed_weights(knn_features, src_knn, tgt_knn, sigma, sigma_d,
                           num_iters=num_iters)
    lead = w.shape[:-1]
    k = w.shape[-1]
    return rigid_transform_3d(
        src_knn.float().reshape(-1, k, 3), tgt_knn.float().reshape(-1, k, 3),
        w.reshape(-1, k)).reshape(*lead, 4, 4)
