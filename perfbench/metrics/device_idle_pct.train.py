"""The share of the traced training window in which no operation ran on the
device, from the profiler's device activity, in percent (layer: device;
moves train_pairs_per_s)."""

from perfbench.tracing import idle_pct as read  # noqa: F401
