"""PyramidNet: a recursive hourglass sparse net (FCGF backbone variant).

Counterpart of ``gmf_tpu/sparse/pyramidnet.py`` (GMF_DGR_fcgf/model/
pyramidnet.py:1-193), run as gmf_tpu runs it, descending then ascending
over one pyramid of ``len(channels)`` levels (4, 6 or 8):

- stem: conv1 (``conv1_kernel_size``, stride 1), norm, ELU;
- level d going down: a stride-2 conv (C[d-1] -> C[d]), norm, ELU, then
  ``depths[d]`` residual blocks (ReLU inside, as every reference block);
- level d going up: a stride-2 transpose conv (TR[d] -> TR[d]), norm,
  ELU, ``ME.cat(skip, y)`` with the skip FIRST, then a bias-free 1x1
  ``cat_conv`` (C[d-1] + TR[d] -> TR[d-1]), norm, ELU;
- final: a k3 conv (TR[0] -> TR[0]), norm, ELU, then a bias-free 1x1 to
  ``out_channels``; optional feature L2 normalization.

``norm``: "bn" (``MaskedBatchNorm``) or "inbn" (``MaskedInstanceNorm``,
then ``MaskedBatchNorm``, model/common.py:16-19). The depth-0
("NoBlock") presets have no residual blocks. Parameter names are
gmf_tpu's flat ones (``down{d}``, ``block{d}_{b}``, ``up{d}``,
``cat_conv{d}``, ``final_conv``, ``final``; each norm ``<conv>_norm``,
``norm1`` for the stem's), since no converter maps ME's nested names
onto them; ``utils/bridge.py`` carries gmf_tpu's variables across.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from gmf_tpu_torch.sparse.conv import (MaskedBatchNorm, MaskedInstanceNorm,
                                       PointwiseConv, SparseConv,
                                       append_sentinel)
from gmf_tpu_torch.sparse.resunet import (SparseBasicBlock,
                                          check_conv1_volume, kernel_map_of)

NORMS = ("bn", "inbn")


class SparsePyramidNet(nn.Module):
    """PyramidNet / PyramidNet6 / PyramidNet8 geometry (+ INBN variants)."""

    def __init__(self, in_channels: int = 3, out_channels: int = 32,
                 channels: Sequence[int] = (32, 64, 128, 128),
                 tr_channels: Sequence[int] = (64, 128, 128, 128),
                 depths: Sequence[int] = (1, 1, 1, 1), dim: int = 3,
                 conv1_kernel_size: int = 3, normalize_feature: bool = False,
                 norm: str = "bn"):
        super().__init__()
        C, TR, D = channels, tr_channels, depths
        if not len(C) == len(TR) == len(D):
            raise ValueError("channels, tr_channels and depths need one "
                             "entry a level")
        # the innermost transpose conv reads the innermost conv's output
        if C[-1] != TR[-1]:
            raise ValueError("the innermost channels and tr_channels must "
                             "match")
        if norm not in NORMS:
            raise ValueError(f"unknown norm {norm!r}; one of {NORMS}")
        kv, kv1 = 3 ** dim, conv1_kernel_size ** dim
        self.levels, self.depths = len(C), tuple(D)
        self.conv1_volume = kv1
        self.normalize_feature = normalize_feature
        self.instance_norm = MaskedInstanceNorm() if norm == "inbn" else None

        def conv(name, cin, cout, k):
            setattr(self, name, SparseConv(cin, cout, k))

        conv("conv1", in_channels, C[0], kv1)
        self.norm1 = MaskedBatchNorm(C[0])
        for d in range(1, self.levels):
            conv(f"down{d}", C[d - 1], C[d], kv)
            setattr(self, f"down{d}_norm", MaskedBatchNorm(C[d]))
            for b in range(D[d]):
                setattr(self, f"block{d}_{b}", SparseBasicBlock(C[d], kv))
            conv(f"up{d}", TR[d], TR[d], kv)
            setattr(self, f"up{d}_norm", MaskedBatchNorm(TR[d]))
            setattr(self, f"cat_conv{d}",
                    PointwiseConv(C[d - 1] + TR[d], TR[d - 1]))
            setattr(self, f"cat_conv{d}_norm", MaskedBatchNorm(TR[d - 1]))
        conv("final_conv", TR[0], TR[0], kv)
        self.final_norm = MaskedBatchNorm(TR[0])
        self.final = PointwiseConv(TR[0], out_channels)

    def _norm_elu(self, x, norm, mask):
        if self.instance_norm is not None:
            x = self.instance_norm(x, mask)
        return F.elu(norm(x, mask))

    def forward(self, feats, pyramid: Dict[str, object]):
        """feats: [cap0, in_channels]; pyramid: a dict of at least
        ``len(channels)`` levels (``resunet.pyramid_to_arrays`` or
        ``device_maps.build_pyramid_arrays_device``)."""
        check_conv1_volume(pyramid, self.conv1_volume)
        L = self.levels
        m = [pyramid[f"mask_{l}"] for l in range(L)]

        def conv(x, name, prefix, l_out):
            return getattr(self, name)(append_sentinel(x),
                                       *kernel_map_of(pyramid, prefix),
                                       m[l_out].shape[0])

        x = self._norm_elu(conv(feats, "conv1", "conv1", 0), self.norm1,
                           m[0])
        skips = [x]
        for d in range(1, L):
            x = self._norm_elu(conv(x, f"down{d}", f"down_{d - 1}", d),
                               getattr(self, f"down{d}_norm"), m[d])
            for b in range(self.depths[d]):
                x = getattr(self, f"block{d}_{b}")(
                    x, m[d], *kernel_map_of(pyramid, f"self_{d}"))
            if d < L - 1:
                skips.append(x)
        y = x
        for d in range(L - 1, 0, -1):
            y = self._norm_elu(conv(y, f"up{d}", f"up_{d - 1}", d - 1),
                               getattr(self, f"up{d}_norm"), m[d - 1])
            y = torch.cat([skips[d - 1], y], dim=-1)  # ME.cat(x, y)
            y = self._norm_elu(getattr(self, f"cat_conv{d}")(y),
                               getattr(self, f"cat_conv{d}_norm"), m[d - 1])
        y = self._norm_elu(conv(y, "final_conv", "self_0", 0),
                           self.final_norm, m[0])
        y = self.final(y)
        if self.normalize_feature:
            y = y / (torch.sqrt((y ** 2).sum(-1, keepdim=True) + 1e-16)
                     + 1e-8)
        return y * m[0][:, None]


def _preset(channels, tr_channels, depths, norm="bn"):
    def make(in_channels=3, out_channels=32, dim=3, conv1_kernel_size=3,
             normalize_feature=False, **kw):
        return SparsePyramidNet(
            in_channels=in_channels, out_channels=out_channels, dim=dim,
            conv1_kernel_size=conv1_kernel_size,
            normalize_feature=normalize_feature, channels=channels,
            tr_channels=tr_channels, depths=depths, norm=norm, **kw)

    return make


# the class table of pyramidnet.py:88-193
_CH4 = (32, 64, 128, 128)
_TR4 = (64, 128, 128, 128)
_CH6 = (32, 64, 128, 192, 256, 256)
_TR6 = (64, 128, 192, 192, 256, 256)
_CH8 = (32, 64, 128, 128, 192, 192, 256, 256)
_TR8 = (64, 128, 128, 192, 192, 192, 256, 256)

PYRAMID_MODELS = {
    "PyramidNet": _preset(_CH4, _TR4, (1,) * 4),
    "PyramidNet6": _preset(_CH6, _TR6, (1,) * 6),
    "PyramidNet6NoBlock": _preset(_CH6, _TR6, (0,) * 6),
    "PyramidNet6INBN": _preset(_CH6, _TR6, (1,) * 6, norm="inbn"),
    "PyramidNet6INBNNoBlock": _preset(_CH6, _TR6, (0,) * 6, norm="inbn"),
    "PyramidNet8": _preset(_CH8, _TR8, (1,) * 8),
    "PyramidNet8INBN": _preset(_CH8, _TR8, (1,) * 8, norm="inbn"),
}
