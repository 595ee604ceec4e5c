"""OANet: the order-aware correspondence encoder (a baseline encoder).

Counterpart of ``gmf_tpu/models/oanet.py`` (GMF_PointDSC/models/
OANet.py:7-156), tokens last [B, N, C]: a PointCN trunk with context
normalization, a soft cluster bottleneck (``DiffPool`` to
``num_clusters`` clusters, order-aware filters across them,
``DiffUnpool`` back), a second PointCN stack and a logits head. As in
gmf_tpu the forward returns the features, or the logits with
``return_logits``; there is no padding mask.

- ``DiffPool``'s softmax runs over the tokens, ``DiffUnpool``'s over the
  clusters.
- ``OAFilter``'s second batch norm (the spatial correlation layer)
  normalizes the CLUSTER axis: its tokens are swapped to [B, C, K].
- Batch norms keep flax's running statistics (momentum 0.9 there, 0.1
  in torch's terms, the biased variance; ``nn/norm.py``).

The module tree carries the reference's torch names
(``gmf_tpu/utils/convert_torch.py::convert_oanet`` reads them):
``l1_1.{0, 1 + 4 i, 3 + 4 i}``, ``down1.conv.{1,3}``,
``l2.{i}.conv1.{1,3}``, ``l2.{i}.conv2.{0,2}``, ``l2.{i}.conv3.{2,4}``,
``up1.conv.{1,3}``, ``l1_2.*`` and ``output``; parameterless layers
(ReLU, the norms without weights, the transposes) hold the positions
between. So a reference ``state_dict`` loads once its k=1 ``Conv1d``
weights [out, in, 1] drop their last axis (``utils/convert_torch.py``).
``dtype``: gmf_tpu's compute type (``nn/compute.py``), parameters f32.
"""

from __future__ import annotations

import torch
from torch import nn

from gmf_tpu_torch.models.blocks import (ContextNormalization,
                                         InstanceNormTokens, xavier_linear)
from gmf_tpu_torch.nn.compute import set_compute_dtype
from gmf_tpu_torch.nn.norm import TokenBatchNorm


class SwapTokens(nn.Module):
    """[B, X, Y] -> [B, Y, X] (the reference's ``trans(1, 2)``)."""

    def forward(self, x):
        return x.transpose(1, 2)


def _bn(channels: int) -> TokenBatchNorm:
    return TokenBatchNorm(channels, eps=1e-5)


def _pointcn_stack(cin: int, C: int, blocks: int) -> nn.Sequential:
    """[Linear(cin, C)] + blocks x [Linear, ContextNorm, BN, ReLU]."""
    layers = [xavier_linear(cin, C)]
    for _ in range(blocks):
        layers += [xavier_linear(C, C), ContextNormalization(), _bn(C),
                   nn.ReLU()]
    return nn.Sequential(*layers)


class DiffPool(nn.Module):
    """Soft pooling of N tokens into K clusters (ref :7-21)."""

    def __init__(self, channels: int, output_points: int):
        super().__init__()
        self.conv = nn.Sequential(InstanceNormTokens(), _bn(channels),
                                  nn.ReLU(),
                                  xavier_linear(channels, output_points))

    def forward(self, x):
        """x: [B, N, C] -> [B, K, C]."""
        S = torch.softmax(self.conv(x), dim=1)  # over the tokens
        return torch.einsum("bnc,bnk->bkc", x, S.to(x.dtype))


class DiffUnpool(nn.Module):
    """Soft unpooling of K clusters back onto N tokens (ref :23-39)."""

    def __init__(self, channels: int, output_points: int):
        super().__init__()
        self.conv = nn.Sequential(InstanceNormTokens(), _bn(channels),
                                  nn.ReLU(),
                                  xavier_linear(channels, output_points))

    def forward(self, x_up, x_down):
        """x_up: [B, N, C], x_down: [B, K, C] -> [B, N, C]."""
        S = torch.softmax(self.conv(x_up), dim=2)  # over the clusters
        return torch.einsum("bkc,bnk->bnc", x_down, S.to(x_down.dtype))


class OAFilter(nn.Module):
    """An order-aware filter over the cluster axis (ref :51-86)."""

    def __init__(self, channels: int, points: int):
        super().__init__()
        C = channels
        self.conv1 = nn.Sequential(InstanceNormTokens(), _bn(C), nn.ReLU(),
                                   xavier_linear(C, C), SwapTokens())
        # the spatial correlation layer: tokens [B, C, K], K channels
        self.conv2 = nn.Sequential(_bn(points), nn.ReLU(),
                                   xavier_linear(points, points))
        self.conv3 = nn.Sequential(SwapTokens(), InstanceNormTokens(),
                                   _bn(C), nn.ReLU(), xavier_linear(C, C))

    def forward(self, x):
        """x: [B, K, C] -> [B, K, C]."""
        out = self.conv1(x)
        out = out + self.conv2(out)
        return self.conv3(out) + x


class OANet(nn.Module):
    """The order-aware encoder (ref :89-156)."""

    def __init__(self, in_dim: int = 6, num_layers: int = 6,
                 num_channels: int = 128, num_clusters: int = 10,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        C, half = num_channels, num_layers // 2
        self.config = dict(in_dim=in_dim, num_layers=num_layers,
                           num_channels=num_channels,
                           num_clusters=num_clusters)
        self.l1_1 = _pointcn_stack(in_dim, C, half)
        self.down1 = DiffPool(C, num_clusters)
        self.l2 = nn.ModuleList(OAFilter(C, num_clusters)
                                for _ in range(half))
        self.up1 = DiffUnpool(C, num_clusters)
        self.l1_2 = _pointcn_stack(2 * C, C, half - 1)
        self.output = xavier_linear(C, 1)
        self.set_dtype(dtype)

    def set_dtype(self, dtype: torch.dtype) -> "OANet":
        """The compute type of every linear layer and batch norm."""
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"unsupported net dtype {dtype}")
        self.dtype = dtype
        set_compute_dtype(self, None if dtype == torch.float32 else dtype)
        return self

    def forward(self, corr_pos, return_logits: bool = False):
        """corr_pos: [B, N, in_dim] -> features [B, N, C], or logits
        [B, N] with ``return_logits``."""
        x1_1 = self.l1_1(corr_pos)
        x2 = self.down1(x1_1)
        for block in self.l2:
            x2 = block(x2)
        x_up = self.up1(x1_1, x2)
        out = self.l1_2(torch.cat([x1_1, x_up.to(x1_1.dtype)], dim=-1))
        if return_logits:
            return self.output(out)[..., 0]
        return out
