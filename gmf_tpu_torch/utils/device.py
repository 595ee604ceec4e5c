"""Device policy of the port's entry points.

Entry points default to the card. Without CUDA they raise unless the
caller asks for the CPU explicitly; nothing carries on quietly on the
CPU. On the card, float32 matmuls and convolutions stay full f32: the
JAX package runs its geometry at ``precision=HIGHEST``, and TF32 keeps
only ~3 decimal digits.
"""

from __future__ import annotations

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
