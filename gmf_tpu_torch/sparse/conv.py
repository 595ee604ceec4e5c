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
weights added into an f32 accumulator; its backward gathers each chunk
again rather than keeping it (``_SparseConv``). ``sparse_conv_compact``
runs the same sum over a compacted schedule (``sparse/compact.py``), the
6-D inlier net's convolution wherever the maps are built on the device. The
gmf_tpu package computes both in plain ``jnp`` (no Pallas kernel), and so
does the port in plain PyTorch.

Parameter names are MinkowskiEngine's (``kernel`` [K, Cin, Cout],
``<norm>.bn.{weight,bias,running_mean,running_var}``), the names
``gmf_tpu/utils/convert_minkowski.py`` reads; kernel rows keep gmf_tpu's
offset order (``hypercube_offsets``: last coordinate fastest).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from gmf_tpu_torch.nn.norm import MOMENTUM


def append_sentinel(x):
    """Append the zero sentinel row: [cap, C] -> [cap + 1, C]."""
    return torch.cat([x, x.new_zeros(1, x.shape[-1])], dim=0)


def _chunk_rows(x, idx, M: int, cin: int):
    """The gathered rows of one chunk of offsets as [M, c * Cin] f32."""
    c = idx.shape[0]
    return x.index_select(0, idx.t().reshape(-1)).view(M, c * cin).float()


class _SparseConv(torch.autograd.Function):
    """``sparse_conv`` with a backward that gathers each chunk again.

    Plain autograd would keep every chunk's gathered [M, 32 * Cin] rows
    for the weight gradient, 2 / Cout of the forward's products in bytes:
    more than the card holds for the 6-D inlier net on dense maps at
    3DMatch scale. This saves only ``x``, ``weights`` and ``nbr``; per
    chunk the backward forms dW = g^T dOut from the gathered rows g and
    adds dOut W^T into the rows ``nbr`` names (``index_add_``, atomic on
    the card).
    """

    @staticmethod
    def forward(ctx, x, weights, nbr, chunk):
        K, M = nbr.shape
        cin, cout = weights.shape[1], weights.shape[2]
        acc = torch.zeros(M, cout, dtype=torch.float32, device=x.device)
        for k0 in range(0, K, chunk):
            idx = nbr[k0:k0 + chunk]
            acc.addmm_(_chunk_rows(x, idx, M, cin),
                       weights[k0:k0 + idx.shape[0]].reshape(-1, cout).float())
        ctx.save_for_backward(x, weights, nbr)
        ctx.chunk = chunk
        return acc.to(x.dtype)

    @staticmethod
    def backward(ctx, dout):
        x, weights, nbr = ctx.saved_tensors
        K, M = nbr.shape
        cin, cout = weights.shape[1], weights.shape[2]
        want_x, want_w = ctx.needs_input_grad[:2]
        dout = dout.float()
        dx = (torch.zeros(x.shape[0], cin, dtype=torch.float32,
                          device=x.device) if want_x else None)
        dw = (torch.empty(K, cin, cout, dtype=torch.float32,
                          device=x.device) if want_w else None)
        for k0 in range(0, K, ctx.chunk):
            idx = nbr[k0:k0 + ctx.chunk]
            c = idx.shape[0]
            if want_w:
                dw[k0:k0 + c] = (_chunk_rows(x, idx, M, cin).t() @ dout
                                 ).view(c, cin, cout)
            if want_x:
                w = weights[k0:k0 + c].reshape(c * cin, cout).float()
                dx.index_add_(0, idx.t().reshape(-1),
                              (dout @ w.t()).view(M * c, cin))
        return (None if dx is None else dx.to(x.dtype),
                None if dw is None else dw.to(weights.dtype), None, None)


def sparse_conv(x, weights, nbr, chunk: int = 32):
    """Sparse convolution by gather and product, ``chunk`` offsets a step.

    Args:
      x: [cap_in + 1, Cin] features WITH the sentinel row appended.
      weights: [K, Cin, Cout] kernel weights (offset-major).
      nbr: [K, M] int32 neighbour table (sentinel = cap_in).

    Returns:
      [M, Cout] in x's dtype, accumulated in f32 (padded output rows are
      zeros as long as their nbr entries are sentinels, which
      ``build_pyramid`` guarantees). Differentiable in ``x`` and
      ``weights`` through ``_SparseConv``, whose backward gathers again
      what the forward gathered.
    """
    return _SparseConv.apply(x, weights, nbr, chunk)


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
    ``nn.Dense``); with a ``compute_dtype`` it computes in that type, as
    a flax ``Dense(dtype=...)`` (``nn/compute.py``)."""

    compute_dtype: Optional[torch.dtype] = None

    def __init__(self, in_channels: int, out_channels: int,
                 bias: bool = False):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_channels, out_channels))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None
        bound = 1.0 / math.sqrt(in_channels)
        nn.init.uniform_(self.kernel, -bound, bound)

    def forward(self, x):
        cd = self.compute_dtype
        kernel, bias = self.kernel, self.bias
        if cd is not None:
            x, kernel = x.to(cd), kernel.to(cd)
            bias = None if bias is None else bias.to(cd)
        out = x @ kernel
        return out if bias is None else out + bias


class MaskedBatchNorm(nn.Module):
    """Batch norm over the valid rows, padded rows multiplied to zero
    (gmf_tpu/sparse/conv.py:176-209). The parameters and statistics live
    in a ``bn`` child, as ME's ``MinkowskiBatchNorm`` keeps them.

    In train mode it normalises with the masked batch mean and biased
    variance over n = sum(mask) + 1e-6 rows, which the gradient flows
    through, and updates the running statistics as flax does:
    ``0.9 * running + 0.1 * batch``, the biased variance included. In
    eval mode it reads the running statistics.
    """

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.bn = nn.BatchNorm1d(channels, eps=eps)

    def forward(self, x, mask):
        """x: [cap, C]; mask: [cap] validity."""
        bn = self.bn
        m = mask[:, None].to(x.dtype)
        if self.training:
            n = m.sum() + 1e-6
            mean = (x * m).sum(0) / n
            var = (((x - mean) ** 2) * m).sum(0) / n
            with torch.no_grad():
                for running, batch in ((bn.running_mean, mean),
                                       (bn.running_var, var)):
                    running.copy_(MOMENTUM * running
                                  + (1 - MOMENTUM) * batch.to(running.dtype))
        else:
            mean, var = bn.running_mean, bn.running_var
        y = (x - mean) * torch.rsqrt(var + bn.eps) * bn.weight + bn.bias
        return y * m


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
