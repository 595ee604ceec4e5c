"""Shared correspondence-network building blocks, tokens last [B, N, C].

Counterpart of ``gmf_tpu/models/blocks.py`` (GMF_PointDSC/models/
common.py:78-145): ``instance_norm_tokens`` (torch's InstanceNorm1d on
tokens: biased variance, eps 1e-3), ``ContextNormalization`` (the same
whitening with the UNBIASED variance, ddof=1, as the reference's
``torch.var``), ``EdgeConv`` (DGCNN) and the ``PointCN`` stack. Batch
norms keep flax's running statistics (``nn/norm.py``); ``dtype`` is
gmf_tpu's compute type (``nn/compute.py``), parameters f32.
"""

from __future__ import annotations

import torch
from torch import nn

from gmf_tpu_torch.geometry.knn import knn
from gmf_tpu_torch.nn.compute import Linear, set_compute_dtype
from gmf_tpu_torch.nn.norm import TokenBatchNorm


def instance_norm_tokens(x, eps: float = 1e-3):
    """Normalize each (sample, channel) of [B, N, C] over the token axis,
    biased variance (torch's InstanceNorm1d, non-affine)."""
    mean = x.mean(1, keepdim=True)
    var = x.var(1, keepdim=True, correction=0)
    return (x - mean) / torch.sqrt(var + eps)


def xavier_linear(cin: int, cout: int, bias: bool = True) -> Linear:
    """A ``Linear`` initialised as gmf_tpu's ``_xavier`` Dense: xavier-
    normal weight, zero bias."""
    layer = Linear(cin, cout, bias=bias)
    nn.init.xavier_normal_(layer.weight)
    if bias:
        nn.init.zeros_(layer.bias)
    return layer


class InstanceNormTokens(nn.Module):
    """``instance_norm_tokens`` as a module (no parameters)."""

    def forward(self, x):
        return instance_norm_tokens(x)


class ContextNormalization(nn.Module):
    """Whiten over the token axis with the unbiased variance, eps 1e-3
    (common.py:112-121; no parameters)."""

    def forward(self, x):
        mean = x.mean(1, keepdim=True)
        var = x.var(1, keepdim=True, correction=1)
        return (x - mean) / torch.sqrt(var + 1e-3)


class EdgeConv(nn.Module):
    """DGCNN edge convolution (common.py:78-109): each point's k nearest
    points in feature space (itself first), a bias-free linear layer over
    [x_j - x_i, x_i], the maximum over the neighbours. Neighbours at equal
    distances are taken in index order (``geometry/knn.py``), which may
    differ from gmf_tpu's ``lax.top_k`` only among exact ties."""

    def __init__(self, in_dim: int, out_dim: int, k: int = 10,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.k = k
        self.conv = xavier_linear(2 * in_dim, out_dim, bias=False)
        set_compute_dtype(self, None if dtype == torch.float32 else dtype)

    def forward(self, x):
        B, N = x.shape[:2]
        idx = knn(x, k=min(self.k, N - 1), normalized=False)   # [B, N, k]
        rows = torch.arange(B, device=x.device)[:, None, None]
        nbrs = x[rows, idx]                                     # [B, N, k, C]
        center = x[:, :, None, :].expand_as(nbrs)
        out = self.conv(torch.cat([nbrs - center, center], dim=-1))
        return out.amax(2)


class PointCN(nn.Module):
    """Linear -> [ContextNorm -> BN -> ReLU around a linear layer] x
    ``num_layers`` (common.py:124-145). ``act_pos`` "post": linear, CN,
    BN, ReLU; "pre": CN, BN, ReLU, linear. Names as gmf_tpu's
    (``layer0``, ``conv_{i}``, ``bn_{i}``)."""

    def __init__(self, in_dim: int, num_layers: int = 6,
                 num_channels: int = 128, act_pos: str = "post",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if act_pos not in ("pre", "post"):
            raise ValueError(f"unknown act_pos {act_pos!r}; 'pre' or 'post'")
        self.act_pos, self.num_layers = act_pos, num_layers
        C = num_channels
        self.layer0 = xavier_linear(in_dim, C)
        self.cn = ContextNormalization()
        for i in range(num_layers):
            setattr(self, f"conv_{i}", xavier_linear(C, C))
            setattr(self, f"bn_{i}", TokenBatchNorm(C, eps=1e-5))
        set_compute_dtype(self, None if dtype == torch.float32 else dtype)

    def forward(self, x):
        x = self.layer0(x)
        for i in range(self.num_layers):
            conv, bn = getattr(self, f"conv_{i}"), getattr(self, f"bn_{i}")
            if self.act_pos == "pre":
                x = conv(torch.relu(bn(self.cn(x))))
            else:
                x = torch.relu(bn(self.cn(conv(x))))
        return x
