"""Layers that compute in a chosen type from f32 parameters.

A flax module built with ``dtype=jnp.bfloat16`` keeps the parameters it
is given (f32 from a checkpoint) and casts at each operation: ``Dense``
and ``Conv`` cast their input, kernel and bias to bf16 and return bf16
(the bias added in bf16); ``LayerNorm`` and ``BatchNorm`` compute their
statistics and the normalisation in f32 and return bf16. Elementwise
operations between their outputs then promote as JAX promotes, which is
as PyTorch does (bf16 with f32 gives f32). These subclasses of PyTorch's
layers do the same when their ``compute_dtype`` is set
(``set_compute_dtype``) and are PyTorch's layers, names and
``state_dict`` keys unchanged, when it is None.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def _cast(t, dtype):
    return None if t is None else t.to(dtype)


def _add_bias(y, bias, dtype, channel_dim: int):
    """y + bias in ``dtype``, the bias along ``channel_dim``."""
    if bias is None:
        return y
    shape = [1] * y.dim()
    shape[channel_dim] = -1
    return y + bias.to(dtype).view(shape)


class Linear(nn.Linear):
    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x):
        cd = self.compute_dtype
        if cd is None:
            return super().forward(x)
        return _add_bias(F.linear(x.to(cd), self.weight.to(cd)), self.bias,
                         cd, -1)


class Conv1d(nn.Conv1d):
    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x):
        cd = self.compute_dtype
        if cd is None:
            return super().forward(x)
        return _add_bias(self._conv_forward(x.to(cd), self.weight.to(cd),
                                            None), self.bias, cd, 1)


class Conv2d(nn.Conv2d):
    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x):
        cd = self.compute_dtype
        if cd is None:
            return super().forward(x)
        return _add_bias(self._conv_forward(x.to(cd), self.weight.to(cd),
                                            None), self.bias, cd, 1)


class LayerNorm(nn.LayerNorm):
    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x):
        cd = self.compute_dtype
        if cd is None:
            return super().forward(x)
        return super().forward(x.float()).to(cd)


def set_compute_dtype(module: nn.Module, dtype: Optional[torch.dtype]):
    """Set ``compute_dtype`` on every layer of ``module`` that has one
    (these classes, ``nn/norm.py``'s batch norms, ``PointwiseConv``);
    None restores computing in the input's type. Returns ``module``."""
    for m in module.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = dtype
    return module
