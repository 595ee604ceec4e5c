"""SimpleNet: a 3-level sparse UNet without residual blocks.

Counterpart of ``gmf_tpu/sparse/simpleunet.py`` (GMF_DGR_fcgf/model/
simpleunet.py, the SimpleNetBN* alternative FCGF backbones):
conv1 (s1) -> conv2 (s2) -> conv3 (s2) -> conv3_tr (up) -> cat ->
conv2_tr (up) -> cat -> conv1_tr (k3, s1) -> final (1x1, bias), batch
norm and ReLU between, optional feature L2 normalization. It reads
levels 0-2 of the same 4-level pyramid as the ResUNets
(``kernel_map.build_pyramid`` or ``device_maps``), hypercube maps.
Parameter names are MinkowskiEngine's, as ``resunet.py``'s.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from gmf_tpu_torch.sparse.conv import (MaskedBatchNorm, PointwiseConv,
                                       SparseConv, append_sentinel)
from gmf_tpu_torch.sparse.resunet import check_conv1_volume, kernel_map_of


class SimpleSparseUNet(nn.Module):
    """SimpleNet geometry (``channels`` C, ``tr_channels`` TR, 3 each)."""

    def __init__(self, in_channels: int = 1, out_channels: int = 32,
                 channels: Sequence[int] = (32, 64, 128),
                 tr_channels: Sequence[int] = (32, 64, 64), dim: int = 3,
                 conv1_kernel_size: int = 3,
                 normalize_feature: bool = False):
        super().__init__()
        kv, kv1 = 3 ** dim, conv1_kernel_size ** dim
        self.conv1_volume = kv1
        self.normalize_feature = normalize_feature
        C, TR = channels, tr_channels
        # (name, in, out, kernel volume)
        layers = (("conv1", in_channels, C[0], kv1), ("conv2", C[0], C[1], kv),
                  ("conv3", C[1], C[2], kv), ("conv3_tr", C[2], TR[2], kv),
                  ("conv2_tr", TR[2] + C[1], TR[1], kv),
                  ("conv1_tr", TR[1] + C[0], TR[0], kv))
        for name, cin, cout, k in layers:
            setattr(self, name, SparseConv(cin, cout, k))
            setattr(self, name.replace("conv", "norm"), MaskedBatchNorm(cout))
        self.final = PointwiseConv(TR[0], out_channels, bias=True)

    def forward(self, feats, pyramid: Dict[str, object]):
        """feats: [cap0, in_channels]; pyramid: a 4-level (or deeper)
        pyramid dict (``resunet.pyramid_to_arrays`` or
        ``device_maps.build_pyramid_arrays_device``)."""
        check_conv1_volume(pyramid, self.conv1_volume)
        m = [pyramid[f"mask_{l}"] for l in range(3)]

        def step(x, name, prefix, l):
            conv = getattr(self, name)
            norm = getattr(self, name.replace("conv", "norm"))
            y = conv(append_sentinel(x), *kernel_map_of(pyramid, prefix),
                     m[l].shape[0])
            return F.relu(norm(y, m[l]))

        out_s1 = step(feats, "conv1", "conv1", 0)
        out_s2 = step(out_s1, "conv2", "down_0", 1)
        out = step(out_s2, "conv3", "down_1", 2)
        out = step(out, "conv3_tr", "up_1", 1)
        out = step(torch.cat([out, out_s2], dim=-1), "conv2_tr", "up_0", 0)
        out = step(torch.cat([out, out_s1], dim=-1), "conv1_tr", "self_0", 0)
        out = self.final(out)
        if self.normalize_feature:
            out = out / torch.sqrt((out ** 2).sum(-1, keepdim=True) + 1e-16)
        return out * m[0][:, None]
