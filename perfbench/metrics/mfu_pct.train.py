"""A training step's counted products, forward and backward
(``perfbench/counts.py``: ``train_flops``), times the traced window's
steps and pairs, over the window's seconds and the peak rate, in percent
(layer: model step; moves train_pairs_per_s)."""

from perfbench import counts


def read(trace):
    steps, work = trace.counts.get("steps", 0), trace.work
    if not steps or not trace.window_s:
        return None
    flops = steps * work["pairs"] * counts.train_flops(
        work["config"], work["n"], work["image_hw"])
    return 100.0 * flops / (trace.window_s * counts.PEAK_FLOPS)
