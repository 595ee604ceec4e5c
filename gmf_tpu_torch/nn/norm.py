"""Batch norm with flax's running statistics.

The reference model's batch norms are flax ``nn.BatchNorm(momentum=0.9)``.
In train mode they normalise with the biased batch variance, as PyTorch's
do, but they also keep the BIASED variance in their running statistics,
``running = 0.9 * running + 0.1 * batch``, where PyTorch's batch norm
keeps the unbiased one, n / (n - 1) larger. These classes keep PyTorch's
modules, names and ``state_dict`` keys and change only that update; eval
mode, which reads the running statistics, is PyTorch's own. With a
``compute_dtype`` (``nn/compute.py``) they normalise in f32 and return
that type, as a flax ``BatchNorm(dtype=...)`` does.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

MOMENTUM = 0.9  # flax's: the weight of the old running statistics


class _FlaxRunningStats:
    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x):
        cd = self.compute_dtype
        if cd is None:
            return self._forward(x)
        return self._forward(x.float()).to(cd)

    def _forward(self, x):
        if not self.training:
            return super().forward(x)
        dims = [0] + list(range(2, x.dim()))
        with torch.no_grad():
            x32 = x.float()
            mean = x32.mean(dims)
            var = x32.var(dims, correction=0)
            for running, batch in ((self.running_mean, mean),
                                   (self.running_var, var)):
                running.mul_(MOMENTUM).add_(
                    ((1 - MOMENTUM) * batch).to(running.dtype))
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                            self.eps)


class BatchNorm1d(_FlaxRunningStats, nn.BatchNorm1d):
    """``nn.BatchNorm1d`` with flax's running-statistics update."""


class BatchNorm2d(_FlaxRunningStats, nn.BatchNorm2d):
    """``nn.BatchNorm2d`` with flax's running-statistics update."""


class TokenBatchNorm(BatchNorm1d):
    """BatchNorm1d over the channel axis of [..., C] tokens, with flax's
    running statistics."""

    def forward(self, x):
        return super().forward(x.reshape(-1, x.shape[-1])).reshape(x.shape)
