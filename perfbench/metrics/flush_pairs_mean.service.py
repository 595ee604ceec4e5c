"""The mean number of real pairs in each flush the service dispatched in
the traced window (pad rows apart), counted by the benchmark's wrapper of
the registrar's ``dispatch_batch`` (layer: service; moves
latency_p95_ms)."""


def read(trace):
    flushes = trace.counts.get("flushes", 0)
    return trace.counts["pairs"] / flushes if flushes else None
