"""Checkpoints: the model's ``state_dict`` and the resolved config.

The port's own format, with the contract of ``gmf_tpu/utils/checkpoint.py``:
a checkpoint carries the weights and the config they were trained with,
so evaluation can rebuild the network from the checkpoint alone. A
checkpoint is a directory holding ``state.pt`` (``torch.save`` of the
``state_dict``, tensors on the CPU) and ``config.json``.
"""

from __future__ import annotations

import importlib
import json
import os
import shutil
from typing import Any, Dict, Optional, Sequence, Tuple

import torch


def save_checkpoint(path: str, state_dict: Dict[str, torch.Tensor],
                    config: Optional[Dict[str, Any]] = None) -> str:
    """Write ``state_dict`` (and ``config``) to the directory ``path``."""
    os.makedirs(path, exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()},
               os.path.join(path, "state.pt"))
    if config is not None:
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump(config, f, indent=2, default=str)
    return path


def load_checkpoint(path: str
                    ) -> Tuple[Dict[str, torch.Tensor], Optional[Dict]]:
    """(state_dict on the CPU, config dict or None) from ``path``."""
    state = torch.load(os.path.join(path, "state.pt"), map_location="cpu",
                       weights_only=True)
    config = None
    cfg_path = os.path.join(path, "config.json")
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            config = json.load(f)
    return state, config


def snapshot_sources(save_dir: str, modules: Sequence[str]) -> list:
    """Copy the named modules' source files into ``save_dir/src/``, under
    their package paths, so that a snapshot records the code that trained
    it. Returns the copied paths."""
    copied = []
    for name in modules:
        mod = importlib.import_module(name)
        src = getattr(mod, "__file__", None)
        if not src or not os.path.exists(src):
            continue
        parts = mod.__name__.split(".")
        dst = os.path.join(save_dir, "src", *parts[:-1],
                           os.path.basename(src))
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        shutil.copyfile(src, dst)
        copied.append(dst)
    return copied
