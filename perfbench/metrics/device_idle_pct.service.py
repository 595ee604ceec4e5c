"""The share of the traced serving window in which no operation ran on the
device, from the profiler's device activity, in percent (layer: device;
moves latency_p95_ms)."""

from perfbench.tracing import idle_pct as read  # noqa: F401
