"""Batch norm with flax's running statistics.

The reference model's batch norms are flax ``nn.BatchNorm(momentum=0.9)``.
In train mode they normalise with the biased batch variance, as PyTorch's
do, but they also keep the BIASED variance in their running statistics,
``running = 0.9 * running + 0.1 * batch``, where PyTorch's batch norm
keeps the unbiased one, n / (n - 1) larger. These classes keep PyTorch's
modules, names and ``state_dict`` keys and change only that update; eval
mode, which reads the running statistics, is PyTorch's own. With a
``compute_dtype`` (``nn/compute.py``) they normalise in f32 and return
that type, as a flax ``BatchNorm(dtype=...)`` does. In a step sharded
over a mesh (``parallel.sharded``) train mode takes the global batch's
statistics, as gmf_tpu's sharded step does; the running statistics then
stay equal on every rank.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from gmf_tpu_torch.parallel.collectives import all_reduce_sum
from gmf_tpu_torch.parallel.mesh import batch_mesh

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
        mesh = batch_mesh()
        if mesh is not None:
            return self._forward_sharded(x, mesh)
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

    def _forward_sharded(self, x, mesh):
        """Train mode over a batch sharded across the mesh's 'data' axis:
        the statistics of the global batch, from every rank's sums, sums of
        squares and counts, in flax's form var = mean(x^2) - mean(x)^2. The
        sums and that difference are taken in f64: in f32 the difference
        cancels where a channel's mean dwarfs its spread (the image
        encoder's), and the card's sharded train step then left the
        bounds that hold it to the step in f64 (chip_smoke.py phase 12).
        The sums' backward is summed over the ranks too, so each rank's
        gradient carries what its rows did to every rank's output."""
        dims = [0] + list(range(2, x.dim()))
        x32 = x.float()
        x64 = x32.double()
        count = torch.tensor(float(x.numel() // x.shape[1]),
                             device=x.device, dtype=torch.float64)
        sums = all_reduce_sum(torch.cat([x64.sum(dims), (x64 * x64).sum(dims),
                                         count[None]]), mesh)
        C = x.shape[1]
        n = sums[-1]
        mean64 = sums[:C] / n
        mean, var = mean64.float(), (sums[C:2 * C] / n
                                     - mean64 * mean64).float()
        with torch.no_grad():
            for running, batch in ((self.running_mean, mean),
                                   (self.running_var, var)):
                running.mul_(MOMENTUM).add_(
                    ((1 - MOMENTUM) * batch.detach()).to(running.dtype))
        shape = [1, C] + [1] * (x.dim() - 2)
        y = (x32 - mean.reshape(shape)) * torch.rsqrt(
            var.reshape(shape) + self.eps)
        return (y * self.weight.float().reshape(shape)
                + self.bias.float().reshape(shape)).to(x.dtype)


class BatchNorm1d(_FlaxRunningStats, nn.BatchNorm1d):
    """``nn.BatchNorm1d`` with flax's running-statistics update."""


class BatchNorm2d(_FlaxRunningStats, nn.BatchNorm2d):
    """``nn.BatchNorm2d`` with flax's running-statistics update."""


class TokenBatchNorm(BatchNorm1d):
    """BatchNorm1d over the channel axis of [..., C] tokens, with flax's
    running statistics."""

    def forward(self, x):
        return super().forward(x.reshape(-1, x.shape[-1])).reshape(x.shape)
