"""The traced run's readings: the device's activity from ``torch.profiler``
over the window, and CUDA events that the benchmark's own hooks record at
the model's and the encoder's boundaries. Nothing is added inside the
program. The profile is read in memory and no trace file is written.
"""

from __future__ import annotations

import collections
import contextlib
import time
from typing import List, Optional

import numpy as np
import torch

WINDOW = "perfbench.window"
NAME_CHARS = 120  # kernel names are cut to this in the breakdown


class Trace:
    """What the per-layer readers read (``metrics/<name>.py``)."""

    def __init__(self):
        self.window_s = 0.0       # host clock over the traced window
        self.busy_s = 0.0         # union of device operations in it
        self.kernels = 0          # device kernels (copies and sets apart)
        self.device_ops = []      # [[name, seconds]], longest first
        self.idle_gaps = []       # [[host activity, seconds]]
        self.forwards: List[dict] = []  # per model call: CUDA-event ms
        self.counts = {}          # drivers/<kind>.py's counts (pairs, ...)
        self.work = {}            # and its shapes for perfbench/counts.py

    @property
    def device_seen(self):
        return self.busy_s > 0.0


def idle_pct(trace: Trace):
    """The share of the traced window in which no operation ran on the
    device, in percent; None where nothing was traced."""
    if not trace.window_s or not trace.busy_s:
        return None
    return 100.0 * max(0.0, 1.0 - trace.busy_s / trace.window_s)


class StageClock:
    """CUDA events at the start and end of ``model``'s forward and of
    ``model.encoder``'s: per call, the encoder's device ms and the ms from
    its end to the model's end (the seed stage), from the events' own
    clock on the device. Host spans ("perfbench.model",
    "perfbench.encoder") mark the same calls in the profile."""

    def __init__(self, model):
        from torch.autograd.profiler import record_function

        self.calls = []
        self._open = None
        spans = {}

        def mark(key):
            def hook(*_):
                e = torch.cuda.Event(enable_timing=True)
                e.record()
                if key in ("start", "enc_start"):
                    name = "model" if key == "start" else "encoder"
                    spans[key] = record_function(f"perfbench.{name}")
                    spans[key].__enter__()
                else:
                    opened = spans.pop("start" if key == "end"
                                       else "enc_start", None)
                    if opened is not None:
                        opened.__exit__(None, None, None)
                if key == "start":
                    self._open = {}
                if self._open is not None:
                    self._open[key] = e
                if key == "end" and self._open is not None:
                    self.calls.append(self._open)
                    self._open = None
            return hook

        self._handles = [
            model.register_forward_pre_hook(mark("start")),
            model.encoder.register_forward_pre_hook(mark("enc_start")),
            model.encoder.register_forward_hook(mark("enc_end")),
            model.register_forward_hook(mark("end")),
        ]

    def remove(self):
        for h in self._handles:
            h.remove()

    def read(self):
        torch.cuda.synchronize()
        out = []
        for c in self.calls:
            if len(c) == 4:
                out.append(dict(
                    model_ms=c["start"].elapsed_time(c["end"]),
                    encoder_ms=c["enc_start"].elapsed_time(c["enc_end"]),
                    after_encoder_ms=c["enc_end"].elapsed_time(c["end"])))
        return out


def _ns(e, which):
    f = getattr(e, which + "_ns", None)
    if f is not None:
        return f()
    return getattr(e, which + "_us")() * 1000


@contextlib.contextmanager
def span(name: str, enabled: bool):
    """A host span of the benchmark's own around a call into a layer, in
    traced runs only."""
    if not enabled:
        yield
        return
    from torch.autograd.profiler import record_function

    with record_function(name):
        yield


@contextlib.contextmanager
def traced(trace: Trace, enabled: bool, model=None):
    """Profile the block as the traced window (when ``enabled``) and fill
    ``trace``; the block's own work ends synchronised."""
    if not enabled:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, record_function

    clock = StageClock(model) if model is not None else None
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            t0 = time.perf_counter()
            yield
            torch.cuda.synchronize()
            trace.window_s = time.perf_counter() - t0
    if clock is not None:
        clock.remove()
        trace.forwards = clock.read()
    read_profile(trace, prof.profiler.kineto_results.events())


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def read_profile(trace: Trace, events):
    """Device busy time, kernel count and the breakdown over the window
    event's span of the profiler's clock."""
    window: Optional[tuple] = None
    device, host = [], []
    for e in events:
        name = e.name()
        start = _ns(e, "start")
        end = start + e.duration_ns() if hasattr(e, "duration_ns") else \
            _ns(e, "end")
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            # a host span's shadow on the device is no device work
            if not name.startswith("perfbench.") and not (
                    hasattr(e, "is_user_annotation")
                    and e.is_user_annotation()):
                device.append((start, end, name))
        elif name == WINDOW:
            window = (start, end)
        else:
            host.append((start, end, name))
    if window is None:
        return
    lo, hi = window
    device = [(max(s, lo), min(e, hi), n) for s, e, n in device
              if e > lo and s < hi]
    by_name = collections.Counter()
    for s, e, n in device:
        by_name[n[:NAME_CHARS]] += (e - s) / 1e9
    trace.device_ops = [[n, t] for n, t in by_name.most_common(10)]
    trace.kernels = sum(1 for _, _, n in device
                        if not n.startswith(("Memcpy", "Memset")))
    busy = _union([(s, e) for s, e, _ in device])
    trace.busy_s = sum(e - s for s, e in busy) / 1e9
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] - edges[i] > 20_000]  # over 20 us
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:2000]
    host = [h for h in host if h[1] > lo and h[0] < hi]
    host.sort()
    starts = np.array([h[0] for h in host], dtype=np.int64)
    ends = np.array([h[1] for h in host], dtype=np.int64)
    idle = collections.Counter()
    for s, e in gaps:
        mid = (s + e) // 2
        upto = int(np.searchsorted(starts, mid, side="right"))
        cover = np.nonzero(ends[:upto] >= mid)[0]
        if len(cover):
            inner = cover[np.argmin(ends[cover] - starts[cover])]
            idle[host[inner][2]] += (e - s) / 1e9
        else:
            idle["(no traced host operation)"] += (e - s) / 1e9
    trace.idle_gaps = [[n, t] for n, t in idle.most_common(10)]
