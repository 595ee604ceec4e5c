"""GMF fusion layers: PerceiverIO-style cross-attention + LCPE.

Counterpart of ``gmf_tpu/nn/fusion.py``. ``out_to_context_dim`` picks the output
width of the attention: the context's (True, PointDSC's variant and the
default) or the queries' (False, DGR's perceiver_io.py:71-95, whose
Fusion-2 attends 256-wide queries into 128-wide image tokens). Module
names follow the
reference's torch modules (``cross_attend_blocks.{0,1}.{norm,
norm_context,fn}``, ``cpe.proj_q``, and ``layers.{i}.{0,1}.{norm,fn}``
for the ``depth`` self-attention layers), which are the names
``gmf_tpu/utils/convert_torch.py::convert_fusion_layer`` reads.

- PreNorm (LayerNorm eps=1e-5) on the query stream, and on the context
  stream for the cross-attention.
- Cross-attention with scale dim_head**-0.5; K/V from one fused Linear
  without bias; output Linear with bias.
- GEGLU feed-forward: Linear(dim -> 2*mult*dim), split as [x, gates],
  x * gelu_exact(gates), Linear(mult*dim -> dim).
- LCPE: depthwise Conv1d (k=3) with 'SAME' padding along the token
  axis, residual, on both streams, only when ``pe=True`` (Fusion-2).
- ``depth`` x (self-attention with ``latent_heads`` heads of
  ``latent_dim_head``, then a feed-forward), each pre-normed with a
  residual, after the cross-attention (depth 0 in every reference
  configuration).
- An optional key mask [B, Nk] (> 0 = valid) on the cross-attention
  puts -1e9 on the logits of padded context tokens.

Tensors are [B, N, C] throughout, as in the JAX package. The linear,
norm and convolution layers take a ``compute_dtype`` (``nn/compute.py``:
flax's ``dtype``, the DGR nets' bf16).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from gmf_tpu_torch.nn.compute import Conv1d, LayerNorm, Linear


def gelu_exact(x):
    """Exact (erf) GELU, torch's default."""
    return F.gelu(x)


class Attention(nn.Module):
    """Multi-head (cross-)attention; ``context_dim`` None is
    self-attention. ``to_out`` maps to the context width when
    ``out_to_context_dim`` (PointDSC), else to the query width (DGR)."""

    def __init__(self, query_dim: int, context_dim: Optional[int] = None,
                 heads: int = 8, dim_head: int = 64,
                 out_to_context_dim: bool = True):
        super().__init__()
        inner = heads * dim_head
        context_dim = query_dim if context_dim is None else context_dim
        self.heads, self.dim_head = heads, dim_head
        self.to_q = Linear(query_dim, inner, bias=False)
        self.to_kv = Linear(context_dim, 2 * inner, bias=False)
        self.to_out = Linear(
            inner, context_dim if out_to_context_dim else query_dim)

    def forward(self, x, context=None, mask=None):
        h, d = self.heads, self.dim_head
        context = x if context is None else context
        B, Nq, _ = x.shape
        Nk = context.shape[1]
        q = self.to_q(x).reshape(B, Nq, h, d).transpose(1, 2)
        k, v = self.to_kv(context).chunk(2, dim=-1)
        k = k.reshape(B, Nk, h, d).transpose(1, 2)
        v = v.reshape(B, Nk, h, d).transpose(1, 2)
        sim = torch.matmul(q, k.transpose(-1, -2)) * (d ** -0.5)
        if mask is not None:
            sim = torch.where(mask[:, None, None, :] > 0, sim,
                              torch.full_like(sim, -1e9))
        out = torch.matmul(sim.softmax(-1), v)
        return self.to_out(out.transpose(1, 2).reshape(B, Nq, h * d))


class GEGLU(nn.Module):
    def forward(self, x):
        x, gates = x.chunk(2, dim=-1)
        return x * gelu_exact(gates)


class FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.Sequential(Linear(dim, dim * mult * 2), GEGLU(),
                                 Linear(dim * mult, dim))

    def forward(self, x):
        return self.net(x)


class PreNorm(nn.Module):
    def __init__(self, dim: int, fn: nn.Module,
                 context_dim: Optional[int] = None):
        super().__init__()
        self.fn = fn
        self.norm = LayerNorm(dim, eps=1e-5)
        self.norm_context = (LayerNorm(context_dim, eps=1e-5)
                             if context_dim is not None else None)

    def forward(self, x, context=None, **kwargs):
        x = self.norm(x)
        if self.norm_context is None:
            return self.fn(x, **kwargs)
        return self.fn(x, context=self.norm_context(context), **kwargs)


class ConvPosEnc(nn.Module):
    """LCPE: depthwise Conv1d (kernel ``k``, 'SAME') residual on the query
    and content streams ([B, N, C] in and out)."""

    def __init__(self, dim_q: int, dim_content: int, k: int = 3):
        super().__init__()
        self.proj_q = Conv1d(dim_q, dim_q, k, padding="same", groups=dim_q)
        self.proj_content = Conv1d(dim_content, dim_content, k,
                                   padding="same", groups=dim_content)

    @staticmethod
    def _residual(conv, x):
        return conv(x.transpose(1, 2)).transpose(1, 2) + x

    def forward(self, q, content):
        return (self._residual(self.proj_q, q),
                self._residual(self.proj_content, content))


class FusionLayer(nn.Module):
    """Cross-attention fusion block: queries [B, Nq, latent_dim] attend
    into the context [B, Nk, dim]; ``pe=True`` adds LCPE (Fusion-2);
    ``depth`` self-attention layers follow; ``out_to_context_dim`` as
    ``Attention``'s."""

    def __init__(self, dim: int, latent_dim: int = 512, depth: int = 0,
                 cross_heads: int = 1, latent_heads: int = 8,
                 cross_dim_head: int = 64, latent_dim_head: int = 64,
                 pe: bool = False, out_to_context_dim: bool = True):
        super().__init__()
        self.cpe = ConvPosEnc(latent_dim, dim) if pe else None
        self.cross_attend_blocks = nn.ModuleList([
            PreNorm(latent_dim,
                    Attention(latent_dim, dim, heads=cross_heads,
                              dim_head=cross_dim_head,
                              out_to_context_dim=out_to_context_dim),
                    context_dim=dim),
            PreNorm(latent_dim, FeedForward(latent_dim)),
        ])
        self.layers = nn.ModuleList([
            nn.ModuleList([
                PreNorm(latent_dim,
                        Attention(latent_dim, heads=latent_heads,
                                  dim_head=latent_dim_head,
                                  out_to_context_dim=False)),
                PreNorm(latent_dim, FeedForward(latent_dim)),
            ]) for _ in range(depth)])

    def forward(self, data, queries_encoder, mask=None):
        x = queries_encoder
        if self.cpe is not None:
            x, data = self.cpe(x, data)
        cross_attn, cross_ff = self.cross_attend_blocks
        x = cross_attn(x, context=data, mask=mask) + x
        x = cross_ff(x) + x
        for self_attn, self_ff in self.layers:
            x = self_attn(x) + x
            x = self_ff(x) + x
        return x
