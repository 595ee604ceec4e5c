"""Sparse convolution on dense kernel maps: gather -> GEMM -> accumulate.

Counterpart of ``gmf_tpu/sparse/conv.py``, which replaces
MinkowskiConvolution's kernels. The feature tensor is [cap + 1, C]:
``cap`` padded voxel rows plus ONE zero sentinel row at index ``cap``;
a missing neighbour's gather reads the sentinel and adds exactly zero,
so the convolution itself needs no mask.

For each offset k the kernel map gives the input rows [M]:
   out[j] = sum_k  W_k^T x[nbr[k, j]]
computed 32 offsets at a time: one gather of the chunk's rows as
[M, 32 * Cin], then one product with the chunk's [32 * Cin, Cout]
weights added into an f32 accumulator. ``sparse_conv_compact`` runs the
same sum over a compacted schedule (``sparse/compact.py``), the 6-D
inlier net's convolution wherever the maps are built on the device. The
gmf_tpu package computes both in plain ``jnp`` (no Pallas kernel), and so
does the port in plain PyTorch.

Parameter names are MinkowskiEngine's (``kernel`` [K, Cin, Cout],
``<norm>.bn.{weight,bias,running_mean,running_var}``), the names
``gmf_tpu/utils/convert_minkowski.py`` reads; kernel rows keep gmf_tpu's
offset order (``hypercube_offsets``: last coordinate fastest).
"""

from __future__ import annotations

import math

import torch
from torch import nn


def append_sentinel(x):
    """Append the zero sentinel row: [cap, C] -> [cap + 1, C]."""
    return torch.cat([x, x.new_zeros(1, x.shape[-1])], dim=0)


def sparse_conv(x, weights, nbr, chunk: int = 32):
    """Sparse convolution by gather and product, ``chunk`` offsets a step.

    Args:
      x: [cap_in + 1, Cin] features WITH the sentinel row appended.
      weights: [K, Cin, Cout] kernel weights (offset-major).
      nbr: [K, M] int32 neighbour table (sentinel = cap_in).

    Returns:
      [M, Cout] in x's dtype, accumulated in f32 (padded output rows are
      zeros as long as their nbr entries are sentinels, which
      ``build_pyramid`` guarantees).
    """
    K, M = nbr.shape
    cin, cout = weights.shape[1], weights.shape[2]
    acc = torch.zeros(M, cout, dtype=torch.float32, device=x.device)
    for k0 in range(0, K, chunk):
        idx = nbr[k0:k0 + chunk]
        c = idx.shape[0]
        g = x.index_select(0, idx.t().reshape(-1)).view(M, c * cin)
        acc.addmm_(g.float(), weights[k0:k0 + c].reshape(c * cin,
                                                         cout).float())
    return acc.to(x.dtype)


def sparse_conv_compact(x, weights, schedule, out_rows: int,
                        row_budget: int = 1 << 16):
    """Two-tier compacted sparse convolution (``sparse/compact.py``).

    Args:
      x: [cap_in + 1, Cin] features WITH the sentinel row appended.
      weights: [K_total, Cin, Cout] the whole kernel (kept ids pick rows).
      schedule: {"dense": (nbr [Kd, M], kept [Kd]) or None, "groups":
        ((in_idx [Nt, T], out_idx [Nt, T], kept [Nt]), ...)}.
      out_rows: M, the output capacity; a padded tile slot writes to the
        trash row ``out_rows``, which is dropped.
      row_budget: gathered rows a step (tiles * T).

    Returns [M, Cout] in x's dtype, accumulated in f32: the dense tier by
    ``sparse_conv``, each step of tiles as a gather of [c, T, Cin], a
    batched product with its [c, Cin, Cout] weights and an ``index_add_``
    of the [c * T, Cout] products (on the card an atomic add, whose order
    varies from run to run in the last bits). Plain autograd
    differentiates it.
    """
    cout = weights.shape[2]
    acc = torch.zeros(out_rows + 1, cout, dtype=torch.float32,
                      device=x.device)
    if schedule["dense"] is not None:
        nbr, kept = schedule["dense"]
        acc[:out_rows] += sparse_conv(x, weights.index_select(0, kept.long()),
                                      nbr).float()
    for in_idx, out_idx, kept in schedule["groups"]:
        nt, tile = in_idx.shape
        step = max(1, row_budget // max(tile, 1))
        for t0 in range(0, nt, step):
            ii, oo = in_idx[t0:t0 + step].long(), out_idx[t0:t0 + step]
            w = weights.index_select(0, kept[t0:t0 + step].long()).float()
            g = x.index_select(0, ii.reshape(-1)).view(*ii.shape, -1)
            z = torch.bmm(g.float(), w)                  # [c, T, Cout]
            acc.index_add_(0, oo.reshape(-1).long(), z.view(-1, cout))
    return acc[:out_rows].to(x.dtype)


class SparseConv(nn.Module):
    """Holds the FULL [num_offsets, Cin, Cout] kernel.

    ``num_offsets`` is the full kernel volume (27 for k3 in 3-D, 729 in
    6-D); a pruned kernel map covers a subset, and ``kept`` (int32 [K'])
    selects the weight rows it applies. Offsets padded into ``kept`` come
    with all-sentinel map rows, so they add zero whatever weight they
    alias. No bias: the reference's k > 1 convolutions have none.
    """

    def __init__(self, in_channels: int, out_channels: int,
                 num_offsets: int):
        super().__init__()
        self.kernel = nn.Parameter(
            torch.empty(num_offsets, in_channels, out_channels))
        # ME's kaiming-uniform over fan_in = K * Cin (gmf_tpu's
        # variance_scaling(1/3, "fan_in", "uniform"))
        bound = 1.0 / math.sqrt(num_offsets * in_channels)
        nn.init.uniform_(self.kernel, -bound, bound)

    def forward(self, x_with_sentinel, nbr, kept=None, out_rows=None):
        """nbr: a dense [K', M] map (with ``kept`` kernel rows), or a
        compacted schedule dict, when ``out_rows`` gives M."""
        if isinstance(nbr, dict):
            return sparse_conv_compact(
                x_with_sentinel, self.kernel.to(x_with_sentinel.dtype), nbr,
                out_rows)
        w = self.kernel if kept is None else self.kernel.index_select(
            0, kept)
        return sparse_conv(x_with_sentinel, w.to(x_with_sentinel.dtype), nbr)


class PointwiseConv(nn.Module):
    """A 1x1 sparse convolution, ME's ``[Cin, Cout]`` kernel (gmf_tpu's
    ``nn.Dense``)."""

    def __init__(self, in_channels: int, out_channels: int,
                 bias: bool = False):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_channels, out_channels))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None
        bound = 1.0 / math.sqrt(in_channels)
        nn.init.uniform_(self.kernel, -bound, bound)

    def forward(self, x):
        out = x @ self.kernel
        return out if self.bias is None else out + self.bias


class MaskedBatchNorm(nn.Module):
    """Batch norm from the running statistics, padded rows multiplied to
    zero (gmf_tpu/sparse/conv.py:206-207). The statistics live in a
    ``bn`` child, as ME's ``MinkowskiBatchNorm`` keeps them.

    Only eval mode is ported: the masked batch statistics of training
    come with DGR training (ROADMAP queue 1 item 5.9), and a module in
    train mode raises.
    """

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.bn = nn.BatchNorm1d(channels, eps=eps)

    def forward(self, x, mask):
        """x: [cap, C]; mask: [cap] validity."""
        if self.training:
            raise NotImplementedError(
                "MaskedBatchNorm in train mode (DGR training, ROADMAP queue "
                "1 item 5.9) is not ported yet; call .eval()")
        bn = self.bn
        y = ((x - bn.running_mean) * torch.rsqrt(bn.running_var + bn.eps)
             * bn.weight + bn.bias)
        return y * mask[:, None].to(x.dtype)


class MaskedInstanceNorm(nn.Module):
    """Per-channel normalization over the valid voxels of one instance,
    non-affine (ME's MinkowskiInstanceNorm in the reference's 'INBN'
    norm, always followed by an affine batch norm there)."""

    def __init__(self, eps: float = 1e-5):
        super().__init__()
        self.eps = eps

    def forward(self, x, mask):
        """x: [cap, C]; mask: [cap] validity."""
        m = mask[:, None].to(x.dtype)
        n = m.sum() + 1e-6
        mean = (x * m).sum(0) / n
        var = (((x - mean) ** 2) * m).sum(0) / n
        return (x - mean) * torch.rsqrt(var + self.eps) * m
