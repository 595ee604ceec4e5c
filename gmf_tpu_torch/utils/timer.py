"""Wall-clock timers and running meters.

Counterpart of ``gmf_tpu/utils/timer.py``, plain Python kept as it is
there (GMF_PointDSC/utils/timer.py:26-55: Timer with tic/toc/avg,
AverageMeter with running variance). Host clocks only: a span that ends
in work on the card must synchronise it first to time more than the
enqueue.
"""

from __future__ import annotations

import time


class Timer:
    """tic/toc accumulator; ``avg`` over all toc'd intervals."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.total_time = 0.0
        self.calls = 0
        self.start_time = 0.0
        self.diff = 0.0
        self.avg = 0.0

    def tic(self):
        self.start_time = time.perf_counter()

    def toc(self, average: bool = True):
        self.diff = time.perf_counter() - self.start_time
        self.total_time += self.diff
        self.calls += 1
        self.avg = self.total_time / self.calls
        return self.avg if average else self.diff


class AverageMeter:
    """Running mean/variance/count meter."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.sq_sum = 0.0
        self.count = 0
        self.var = 0.0

    def update(self, val, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count
        self.sq_sum += (val ** 2) * n
        if self.count > 1:
            self.var = (self.sq_sum - self.count * self.avg ** 2) / (
                self.count - 1
            )
