"""Profiling / tracing utilities.

Counterpart of ``gmf_tpu/utils/profiling.py``. The reference instruments
data-vs-model wall-clock with manual timers (``utils/timer.py``); this
module adds the device layer:

- ``trace``: a ``torch.profiler`` capture (CPU activity, and CUDA kernels
  where a card is present) around a block, written as a Chrome trace into
  ``log_dir`` (open it in ``chrome://tracing`` or Perfetto);
- ``annotation``: a named, nestable region inside it;
- ``device_memory_stats``: the card's live and peak allocation and its
  memory size, the three keys ``gmf_tpu`` reports (the reference logs
  CUDA high-water marks, evaluation/test_3DMatch.py:154); ``{}`` for the
  CPU.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Iterator, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from gmf_tpu_torch.utils.device import resolve_device


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None,
          annotate: Optional[str] = None) -> Iterator[profile]:
    """Profile the ``with`` body and write ``trace_<pid>_<ns>.json`` into
    ``log_dir`` (default: ``gmf_trace`` in the temporary directory).
    Yields the profiler, whose ``key_averages()`` sums the events by name
    once the block has ended."""
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "gmf_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    with prof:
        if annotate:
            with record_function(annotate):
                yield prof
        else:
            yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def annotation(name: str):
    """Named region inside a trace (nestable)."""
    return record_function(name)


def device_memory_stats(device=None) -> dict:
    """Live/peak allocated bytes and the memory size of a card (``None``
    is the card, as every entry point's default; it raises without one);
    ``{}`` for a CPU device."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return {}
    stats = torch.cuda.memory_stats(dev)
    return {
        "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
        "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
        "bytes_limit": torch.cuda.mem_get_info(dev)[1],
    }
