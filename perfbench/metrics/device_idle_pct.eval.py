"""The share of the traced window in which no operation ran on the
device, from the profiler's device activity, in percent (layer: device;
moves pairs_per_s)."""

from perfbench.tracing import idle_pct as read  # noqa: F401
