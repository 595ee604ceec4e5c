"""MinkowskiEngine checkpoints -> the port's sparse ResUNet state_dict.

Counterpart of ``gmf_tpu/utils/convert_minkowski.py``. The port's sparse
nets keep ME's names (``conv1.kernel``, ``norm1.bn.*``,
``block1.conv1.kernel``; ``sparse/conv.py``) and ME's [K, Cin, Cout]
kernel layout, so the conversion is:

- the rows of every k > 1 kernel permuted from ME's offset order to the
  port's (``me_offset_permutation``);
- the 1x1 convolutions (``conv1_tr``, ``final``) as they are, [Cin, Cout],
  ``final.bias`` flattened;
- batch norms as they are (a missing ``num_batches_tracked`` set to 0);
- with ``with_gmf_fusion`` the image encoder's trunk (conv1, bn1, layer1,
  layer2) and both fusion layers, whose torch names and layouts are the
  port's own.

Offset order: ME enumerates hypercube offsets with the FIRST coordinate
varying fastest, the port (as gmf_tpu) the LAST. That convention is
calibrated against gmf_tpu's converter, not against ME itself: set
``me_fastest='last'`` if a checkpoint turns out to use the other one
(check once against a known activation).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from gmf_tpu_torch.sparse.kernel_map import hypercube_offsets

_BN = ("weight", "bias", "running_mean", "running_var")


def me_offset_permutation(kernel_size: int, dim: int,
                          me_fastest: str = "first") -> np.ndarray:
    """perm[k_port] = k_me: reorders ME kernel rows into the port's
    offset order."""
    ours = hypercube_offsets(kernel_size, dim)  # last dim fastest
    r = kernel_size // 2
    if me_fastest == "first":
        # ME's index: sum_d (o_d + r) k^d, dim 0 least significant
        weights = kernel_size ** np.arange(dim)
    else:
        weights = kernel_size ** np.arange(dim)[::-1]
    return ((ours + r) @ weights).astype(np.int64)


def _image_encoder_modules(sd, prefix: str) -> List[str]:
    """The ResNet-34 trunk's modules the port's ImageEncoder holds."""
    mods = [f"{prefix}conv1", f"{prefix}bn1"]
    for stage, blocks in (("layer1", 3), ("layer2", 4)):
        for i in range(blocks):
            b = f"{prefix}{stage}.{i}"
            mods += [f"{b}.conv1", f"{b}.bn1", f"{b}.conv2", f"{b}.bn2"]
            if f"{b}.downsample.0.weight" in sd:
                mods += [f"{b}.downsample.0", f"{b}.downsample.1"]
    return mods


def _fusion_modules(prefix: str, pe: bool) -> List[str]:
    """A depth-0 FusionLayer's modules (``nn/fusion.py``)."""
    cab = f"{prefix}cross_attend_blocks"
    mods = [f"{cab}.0.norm", f"{cab}.0.norm_context", f"{cab}.0.fn.to_q",
            f"{cab}.0.fn.to_kv", f"{cab}.0.fn.to_out", f"{cab}.1.norm",
            f"{cab}.1.fn.net.0", f"{cab}.1.fn.net.2"]
    if pe:
        mods += [f"{prefix}cpe.proj_q", f"{prefix}cpe.proj_content"]
    return mods


def convert_sparse_resunet(sd: Dict[str, object], dim: int = 3,
                           conv1_kernel_size: int = 7,
                           with_gmf_fusion: bool = False,
                           me_fastest: str = "first"
                           ) -> Dict[str, torch.Tensor]:
    """A ResUNetBN2C ``state_dict`` (resunet.py / resunet_new.py) as the
    port's ``SparseResUNet2`` state_dict (module docstring)."""
    sd = {k: torch.as_tensor(np.asarray(v)) for k, v in sd.items()}
    out: Dict[str, torch.Tensor] = {}

    def conv(name, kernel_size):
        perm = me_offset_permutation(kernel_size, dim, me_fastest)
        w = sd[f"{name}.kernel"][torch.from_numpy(perm)]
        out[f"{name}.kernel"] = w.float().contiguous()

    def bn(name):
        for field in _BN:
            out[f"{name}.{field}"] = sd[f"{name}.{field}"].float()
        out[f"{name}.num_batches_tracked"] = sd.get(
            f"{name}.num_batches_tracked", torch.tensor(0, dtype=torch.long))

    def block(name):
        for i in (1, 2):
            conv(f"{name}.conv{i}", 3)
            bn(f"{name}.norm{i}.bn")

    conv("conv1", conv1_kernel_size)
    bn("norm1.bn")
    block("block1")
    for lvl in ("2", "3", "4", "4_tr", "3_tr", "2_tr"):
        conv(f"conv{lvl}", 3)
        bn(f"norm{lvl}.bn")
        block(f"block{lvl}")
    for name in ("conv1_tr", "final"):  # ME keeps 1x1 kernels 2-D
        w = sd[f"{name}.kernel"]
        out[f"{name}.kernel"] = w.reshape(w.shape[-2:]).float().contiguous()
    out["final.bias"] = sd["final.bias"].reshape(-1).float()

    if with_gmf_fusion:
        mods = (_image_encoder_modules(sd, "img_encoder.backbone.")
                + _fusion_modules("image_fusion.", pe=False)
                + _fusion_modules("perceiver_io.", pe=True))
        for m in mods:
            for field in ("weight", "bias") + _BN[2:]:
                if f"{m}.{field}" in sd:
                    out[f"{m}.{field}"] = sd[f"{m}.{field}"].float()
            if f"{m}.running_mean" in sd:
                out[f"{m}.num_batches_tracked"] = sd.get(
                    f"{m}.num_batches_tracked",
                    torch.tensor(0, dtype=torch.long))
    return out
