"""Sparse ResUNet family: the FCGF descriptor net and the GMF-fused 6-D
inlier net.

Counterpart of ``gmf_tpu/sparse/resunet.py``:
- ``ResUNetBN2C`` (GMF_DGR_fcgf/model/resunet.py, misc/fcgf.py): a
  4-level encoder CHANNELS=[32,64,128,256], a 3-level decoder
  TR=[64,64,64,128], residual BasicBlocks, skip concatenations, a final
  1x1 convolution, optional feature L2-norm.
- its GMF variant (model/resunet_new.py, D=6): the same trunk plus an
  ImageEncoder on both frames, Fusion-1 across the image tokens, and a
  PerceiverIO Fusion-2 with LCPE that REPLACES the bottleneck features.

Every convolution is ``sparse/conv.py``'s gather-GEMM over the pyramid's
kernel maps (host- or device-built), or over its compacted schedules
where it has them (``*_cmp`` keys); batch norms multiply padded rows to
zero, so padded rows stay zero throughout (LCPE's depthwise convolution
reads them). The
block order is the reference's, including the pre-ReLU skip
concatenations (gmf_tpu/sparse/resunet.py:156-226).
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gmf_tpu_torch.nn.compute import set_compute_dtype
from gmf_tpu_torch.nn.fusion import FusionLayer
from gmf_tpu_torch.nn.resnet import ImageEncoder
from gmf_tpu_torch.sparse.conv import (MaskedBatchNorm, PointwiseConv,
                                       SparseConv, append_sentinel)
from gmf_tpu_torch.sparse.kernel_map import region_offsets


def pyramid_to_arrays(pyr, device) -> Dict[str, object]:
    """A host ``SparsePyramid`` as the nets' dict of tensors on ``device``
    (maps and kept ids int32, masks f32), plus ``conv1_volume`` (an int:
    the offsets of conv1's kernel before pruning)."""
    arrays: Dict[str, object] = {
        "conv1_map": torch.from_numpy(pyr.conv1_map).to(device),
        "conv1_kept": torch.from_numpy(pyr.conv1_kept).to(device),
        "conv1_volume": int(pyr.conv1_volume),
    }
    for l, lv in enumerate(pyr.levels):
        mask = (np.arange(lv.cap) < lv.num_valid).astype(np.float32)
        arrays[f"mask_{l}"] = torch.from_numpy(mask).to(device)
        arrays[f"self_map_{l}"] = torch.from_numpy(lv.self_map).to(device)
        arrays[f"self_kept_{l}"] = torch.from_numpy(lv.self_kept).to(device)
        if lv.down_map is not None:
            for name in ("down_map", "down_kept", "up_map", "up_kept"):
                arrays[f"{name}_{l}"] = torch.from_numpy(
                    getattr(lv, name)).to(device)
    return arrays


def kernel_map_of(pyramid: Dict[str, object], prefix: str):
    """(map, kept) of "conv1", "self_l", "down_l" or "up_l" in a pyramid
    dict; a compacted schedule (``*_cmp``) comes first, with kept None."""
    cmp_key = "conv1_cmp" if prefix == "conv1" else prefix.replace(
        "_", "_cmp_")
    if cmp_key in pyramid:
        return pyramid[cmp_key], None
    if prefix == "conv1":
        return pyramid["conv1_map"], pyramid["conv1_kept"]
    return (pyramid[prefix.replace("_", "_map_")],
            pyramid[prefix.replace("_", "_kept_")])


def check_conv1_volume(pyramid: Dict[str, object], volume: int) -> None:
    """Raise unless the pyramid's conv1 map was built for a kernel of
    ``volume`` offsets (its ``conv1_volume``, where it records one)."""
    got = pyramid.get("conv1_volume")
    if got is not None and got != volume:
        raise ValueError(
            f"the pyramid's conv1 map covers {got} offsets, the net's "
            f"conv1 kernel {volume}: build the pyramid with the net's "
            "conv1_kernel_size and region")


class SparseBasicBlock(nn.Module):
    """conv-BN-ReLU-conv-BN + skip, ReLU at the end (GMF_DGR
    model/residual_block.py BasicBlockBN)."""

    def __init__(self, channels: int, kernel_volume: int):
        super().__init__()
        self.conv1 = SparseConv(channels, channels, kernel_volume)
        self.norm1 = MaskedBatchNorm(channels)
        self.conv2 = SparseConv(channels, channels, kernel_volume)
        self.norm2 = MaskedBatchNorm(channels)

    def forward(self, x, mask, self_map, kept):
        rows = x.shape[0]  # a self map's output capacity is its input's
        out = F.relu(self.norm1(
            self.conv1(append_sentinel(x), self_map, kept, rows), mask))
        out = self.norm2(self.conv2(append_sentinel(out), self_map, kept,
                                    rows), mask)
        return F.relu(out + x)


class SparseResUNet2(nn.Module):
    """4-level sparse ResUNet (``ResUNetBN2C`` geometry); with
    ``with_gmf_fusion`` the DGR inlier net's image path joins it.
    ``.train()`` and ``.eval()`` reach every batch norm (the masked ones
    and the image encoder's).

    ``dtype``: the compute type of gmf_tpu's ``dtype`` with f32 parameters
    (a checkpoint's): in bf16 the image encoder, both fusion layers,
    ``conv1_tr`` and ``final`` compute in bf16, while the sparse trunk,
    whose flax modules take their parameters' type, stays f32; the
    output is f32 (the mask promotes it). Parameters stay f32 either way.
    """

    def __init__(self, in_channels: int = 1, out_channels: int = 32,
                 channels: Sequence[int] = (32, 64, 128, 256),
                 tr_channels: Sequence[int] = (64, 64, 64, 128),
                 dim: int = 3, conv1_kernel_size: int = 3,
                 normalize_feature: bool = False,
                 with_gmf_fusion: bool = False, image_dim: int = 128,
                 region: str = "hypercube",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        # "hypercross" (the registry's *X variants): the centre and 2 r
        # offsets an axis (gmf_tpu/sparse/resunet.py:97-110)
        offs = region_offsets(region)
        kv, kv1 = len(offs(3, dim)), len(offs(conv1_kernel_size, dim))
        self.region = region
        self.conv1_kernel_size, self.conv1_volume = conv1_kernel_size, kv1
        self.normalize_feature = normalize_feature
        self.with_gmf_fusion = with_gmf_fusion
        C, TR = channels, tr_channels

        self.conv1 = SparseConv(in_channels, C[0], kv1)
        self.norm1 = MaskedBatchNorm(C[0])
        self.block1 = SparseBasicBlock(C[0], kv)
        for i in (2, 3, 4):
            setattr(self, f"conv{i}", SparseConv(C[i - 2], C[i - 1], kv))
            setattr(self, f"norm{i}", MaskedBatchNorm(C[i - 1]))
            setattr(self, f"block{i}", SparseBasicBlock(C[i - 1], kv))
        # decoder: conv{i}_tr reads level i-1's features (skip included)
        tr_in = {4: C[3], 3: TR[3] + C[2], 2: TR[2] + C[1]}
        for i in (4, 3, 2):
            setattr(self, f"conv{i}_tr",
                    SparseConv(tr_in[i], TR[i - 1], kv))
            setattr(self, f"norm{i}_tr", MaskedBatchNorm(TR[i - 1]))
            setattr(self, f"block{i}_tr", SparseBasicBlock(TR[i - 1], kv))
        self.conv1_tr = PointwiseConv(TR[1] + C[0], TR[0])
        self.final = PointwiseConv(TR[0], out_channels, bias=True)

        if with_gmf_fusion:
            self.img_encoder = ImageEncoder(base_width=image_dim // 2)
            # Fusion-1 (resunet_new.py:616-626): DGR's attention maps to
            # the query width
            self.image_fusion = FusionLayer(
                dim=image_dim, latent_dim=image_dim, cross_heads=1,
                cross_dim_head=64, pe=False, out_to_context_dim=False)
            # Fusion-2 (resunet_new.py:660, 694-705) at the bottleneck
            self.perceiver_io = FusionLayer(
                dim=image_dim, latent_dim=C[3], cross_heads=1,
                cross_dim_head=C[3] // 2, pe=True, out_to_context_dim=False)
        self.set_dtype(dtype)

    def set_dtype(self, dtype: torch.dtype) -> "SparseResUNet2":
        """Set the compute type (the class docstring's ``dtype``)."""
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"unsupported net dtype {dtype}")
        self.dtype = dtype
        cd = None if dtype == torch.float32 else dtype
        for part in (self.conv1_tr, self.final) + ((
                self.img_encoder, self.image_fusion, self.perceiver_io)
                if self.with_gmf_fusion else ()):
            set_compute_dtype(part, cd)
        return self

    def forward(self, feats, pyramid: Dict[str, object], p_image=None,
                q_image=None):
        """feats: [cap0, in_channels]; pyramid: ``pyramid_to_arrays``'s or
        ``build_pyramid_arrays_device``'s dict; p_image/q_image: [1, H, W,
        3] frames (GMF variant)."""
        check_conv1_volume(pyramid, self.conv1_volume)
        m = [pyramid[f"mask_{l}"] for l in range(4)]

        def kmap(prefix):
            return kernel_map_of(pyramid, prefix)

        def level(x, conv, norm, block, prefix, l):
            x = conv(append_sentinel(x), *kmap(prefix), m[l].shape[0])
            x = norm(x, m[l])
            return block(x, m[l], *kmap(f"self_{l}"))

        image_feat = None
        if self.with_gmf_fusion:
            if p_image is None or q_image is None:
                raise ValueError("the GMF inlier net needs both frames")
            p_tok = self.img_encoder.tokens(p_image)
            q_tok = self.img_encoder.tokens(q_image)
            image_feat = self.image_fusion(p_tok, queries_encoder=q_tok)

        # encoder
        out_s1 = level(feats, self.conv1, self.norm1, self.block1,
                       "conv1", 0)
        out_s2 = level(F.relu(out_s1), self.conv2, self.norm2, self.block2,
                       "down_0", 1)
        out_s4 = level(F.relu(out_s2), self.conv3, self.norm3, self.block3,
                       "down_1", 2)
        out_s8 = level(F.relu(out_s4), self.conv4, self.norm4, self.block4,
                       "down_2", 3)
        out = F.relu(out_s8)

        # GMF Fusion-2: PerceiverIO's output REPLACES the bottleneck
        if self.with_gmf_fusion:
            out = self.perceiver_io(image_feat, queries_encoder=out[None])[0]
            out = out * m[3][:, None]

        # decoder, concatenating each pre-ReLU encoder output
        out = F.relu(level(out, self.conv4_tr, self.norm4_tr, self.block4_tr,
                           "up_2", 2))
        out = torch.cat([out, out_s4], dim=-1)
        out = F.relu(level(out, self.conv3_tr, self.norm3_tr, self.block3_tr,
                           "up_1", 1))
        out = torch.cat([out, out_s2], dim=-1)
        out = F.relu(level(out, self.conv2_tr, self.norm2_tr, self.block2_tr,
                           "up_0", 0))
        out = torch.cat([out, out_s1], dim=-1)
        out = self.final(F.relu(self.conv1_tr(out)))

        if self.normalize_feature:
            out = out / (torch.sqrt((out ** 2).sum(-1, keepdim=True)
                                    + 1e-16) + 1e-8)
        return out * m[0][:, None]


def FCGFNet(out_channels: int = 32, conv1_kernel_size: int = 7,
            normalize_feature: bool = True, dtype=torch.float32):
    """FCGF descriptor backbone (misc/fcgf.py ResUNetBN2C, 1->32, conv1 7,
    voxel 0.05)."""
    return SparseResUNet2(in_channels=1, out_channels=out_channels, dim=3,
                          conv1_kernel_size=conv1_kernel_size,
                          normalize_feature=normalize_feature, dtype=dtype)


def GMFInlierNet(dim: int = 6, conv1_kernel_size: int = 3,
                 in_channels: int = 1, dtype=torch.float32):
    """GMF-fused 6-D inlier classifier (resunet_new.py ResUNetBN2C, C->1);
    ``in_channels`` follows the engine's inlier_feature_type."""
    return SparseResUNet2(in_channels=in_channels, out_channels=1, dim=dim,
                          conv1_kernel_size=conv1_kernel_size,
                          normalize_feature=False, with_gmf_fusion=True,
                          dtype=dtype)
