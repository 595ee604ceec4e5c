"""Device policy of the port's entry points.

Entry points default to the card. Without CUDA they raise unless the
caller asks for the CPU explicitly; nothing carries on quietly on the
CPU. On the card, float32 matmuls and convolutions stay full f32: the
JAX package runs its geometry at ``precision=HIGHEST``, and TF32 keeps
only ~3 decimal digits.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, Optional

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> cuda. Raises if CUDA is asked for but absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the port "
                "on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


@contextlib.contextmanager
def timed_stage(seconds: Optional[Dict[str, float]], name: str, device):
    """Add the seconds of the ``with`` body to ``seconds[name]``, the card
    synchronised at both ends; nothing at all when ``seconds`` is None."""
    if seconds is None:
        yield
        return
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    yield
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t0


def time_ms(fn: Callable[[], torch.Tensor], device, reps: int = 10) -> float:
    """ms a call of ``fn`` after one warm-up: CUDA events on the card,
    the host clock on the CPU."""
    fn()
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(device)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3
