"""The model registry: a network's name -> its constructor.

Counterpart of ``gmf_tpu/models/registry.py`` (GMF_DGR_fcgf/model/
__init__.py:25-41 ``load_model(name)``): the names a checkpoint records
resolve to the port's classes, the same 15 as gmf_tpu's: the ResUNet zoo
(with the hypercross ``ResUNetBN2CX``), SimpleNet, the PyramidNet
presets, PointDSC and OANet.
"""

from __future__ import annotations

from typing import Callable, Dict

from gmf_tpu_torch.models.oanet import OANet
from gmf_tpu_torch.models.pointdsc import PointDSC
from gmf_tpu_torch.sparse.pyramidnet import PYRAMID_MODELS
from gmf_tpu_torch.sparse.resunet import SparseResUNet2
from gmf_tpu_torch.sparse.simpleunet import SimpleSparseUNet


def _resunet(channels, tr_channels, region="hypercube"):
    def make(in_channels=1, out_channels=32, dim=3, conv1_kernel_size=3,
             normalize_feature=False, **kw):
        return SparseResUNet2(
            in_channels=in_channels, out_channels=out_channels, dim=dim,
            conv1_kernel_size=conv1_kernel_size,
            normalize_feature=normalize_feature, channels=channels,
            tr_channels=tr_channels, region=region, **kw)

    return make


def _simplenet(channels, tr_channels):
    def make(**kw):
        return SimpleSparseUNet(channels=channels, tr_channels=tr_channels,
                                **kw)

    return make


MODELS: Dict[str, Callable] = {
    # the ResUNet zoo (model/resunet.py and misc/fcgf.py's class table)
    "ResUNetBN2": _resunet((32, 64, 128, 256), (32, 64, 64, 128)),
    "ResUNetBN2B": _resunet((32, 64, 128, 256), (64, 64, 64, 64)),
    "ResUNetBN2C": _resunet((32, 64, 128, 256), (64, 64, 64, 128)),
    "ResUNetBN2CX": _resunet((32, 64, 128, 256), (64, 64, 64, 128),
                             region="hypercross"),
    # the SimpleNet zoo (model/simpleunet.py): 3 levels, no residuals
    "SimpleNetBN": _simplenet((32, 64, 128), (32, 64, 64)),
    "SimpleNetBN2C": _simplenet((32, 64, 128), (64, 64, 64)),
    # the PyramidNet hourglass zoo (model/pyramidnet.py:88-193)
    **PYRAMID_MODELS,
    # the correspondence encoders
    "PointDSC": PointDSC,
    "OANet": OANet,
}


def load_model(name: str) -> Callable:
    """The constructor registered under ``name``; an unknown name raises
    ``KeyError`` listing the names."""
    if name not in MODELS:
        raise KeyError(f"unknown model {name!r}; available: {sorted(MODELS)}")
    return MODELS[name]
