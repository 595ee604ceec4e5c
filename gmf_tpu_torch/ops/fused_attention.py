"""Compat-modulated attention: streaming CUDA kernel and its plain version.

Counterpart of ``gmf_tpu/ops/fused_attention.py::compat_flash_attention``
(streaming mode, forward only), batched over pairs:

    compat[i,j] = max(0, 1 - (|s_i - s_j| - |t_i - t_j|)^2 / sigma^2)
    out         = softmax(compat * (q . k) / sqrt(D), masked keys -1e9) @ v

``compat_flash_attention`` launches ``csrc/compat_flash_attention.cu`` on
CUDA tensors and uses ``compat_attention_plain`` only for CPU tensors.
The backward (training) and the int8 compat-cache kernels are not ported
yet.
"""

from __future__ import annotations

import math

import torch

from gmf_tpu_torch.ops import _build

NEG_INF = -1e9
_LOG2E = 1.4426950408889634
KERNEL = "compat_flash_attention"


def _pairwise_dist(x):
    """[B, N, 3] -> [B, N, N] Euclidean distances, per-coordinate
    differences (no norm-identity cancellation)."""
    d2 = None
    for c in range(3):
        diff = x[:, :, None, c] - x[:, None, :, c]
        d2 = diff * diff if d2 is None else d2 + diff * diff
    return torch.sqrt(d2)


def _qscale(D: int) -> float:
    """scale * log2(e): folds the 1/sqrt(D) scale and the base-2 softmax
    into q."""
    return (1.0 / math.sqrt(D)) * _LOG2E


def compat_attention_plain(q, k, v, src_keypts, tgt_keypts, mask=None,
                           sigma_d: float = 0.10):
    """Dense version: materialises the [B, N, N] compat and logits in f32.
    q, k, v [B, N, D]; keypoints [B, N, 3]; mask [B, N] -> [B, N, D].

    The softmax is base 2 with scale * log2(e) folded into q, as in the
    kernel. Under bf16 the scaled q and the probabilities are rounded to
    bf16 before their products, as the kernel does, so the two differ only
    by f32 summation order and the kernel's running max.
    """
    D = q.shape[-1]
    rounded = q.dtype == torch.bfloat16
    compat = _pairwise_dist(src_keypts.float()) - _pairwise_dist(
        tgt_keypts.float())
    compat = torch.clamp(1.0 - compat * compat / sigma_d ** 2, min=0.0)
    qs = q.float() * _qscale(D)
    if rounded:
        qs = qs.to(torch.bfloat16).float()
    logits = compat * torch.matmul(qs, k.float().transpose(-1, -2))
    if mask is not None:
        logits = torch.where(mask[:, None, :] > 0, logits,
                             torch.full_like(logits, NEG_INF))
    p = torch.exp2(logits - logits.amax(dim=-1, keepdim=True))
    denom = p.sum(dim=-1, keepdim=True)
    if rounded:
        p = p.to(torch.bfloat16).float()
    out = torch.matmul(p, v.float()) / denom
    return out.to(q.dtype)


def compat_flash_attention(q, k, v, src_keypts, tgt_keypts, mask=None,
                           sigma_d: float = 0.10):
    """Compat-modulated single-head attention over a batch of pairs.

    q, k, v: [B, N, D] f32 or bf16 (D in 32, 128 on CUDA);
    src_keypts, tgt_keypts: [B, N, 3]; mask: optional [B, N] key validity.
    Returns [B, N, D] in q's dtype.
    """
    if q.device.type == "cpu":
        return compat_attention_plain(q, k, v, src_keypts, tgt_keypts, mask,
                                      sigma_d)
    if q.device.type != "cuda":
        raise ValueError(f"{KERNEL}: unsupported device {q.device}")
    B, N, D = q.shape
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{KERNEL}: q/k/v must be f32 or bf16, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{KERNEL}: q, k and v must share a dtype")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{KERNEL}: q/k/v shapes differ")
    if D not in (32, 128):
        raise ValueError(f"{KERNEL}: head width {D} not built (32/128)")
    if src_keypts.shape != (B, N, 3) or tgt_keypts.shape != (B, N, 3):
        raise ValueError(f"{KERNEL}: keypoints must be [B, N, 3]")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    src = src_keypts.float().contiguous()
    tgt = tgt_keypts.float().contiguous()
    m = (torch.ones(B, N, device=q.device) if mask is None
         else mask.float().contiguous())
    if m.shape != (B, N):
        raise ValueError(f"{KERNEL}: mask must be [B, N]")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out  # nothing to launch
    code = _build.load().gmf_compat_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), src.data_ptr(),
        tgt.data_ptr(), m.data_ptr(), out.data_ptr(), B, N, D,
        int(q.dtype == torch.bfloat16), float(sigma_d) ** 2, _qscale(D),
        _build.stream_of(q))
    _build.check(code, KERNEL)
    return out
