"""Checkpoints: the model's ``state_dict`` and the resolved config.

The port's own format, with the contract of ``gmf_tpu/utils/checkpoint.py``:
a checkpoint carries the weights and the config they were trained with,
so evaluation can rebuild the network from the checkpoint alone. A
checkpoint is a directory holding ``state.pt`` (``torch.save`` of the
``state_dict``, tensors on the CPU) and ``config.json``.

``load_checkpoint`` also reads the directories ``gmf_tpu`` writes: its
``state.msgpack`` (flax's msgpack serialisation, decoded by
``utils/flax_msgpack.py`` without flax or msgpack) comes back as
``gmf_tpu``'s own tree, ``params``, ``batch_stats`` and whatever else it
holds, which ``utils/model_io.py::load_state`` converts to a model's
``state_dict``. ``state.orbax`` (``gmf_tpu``'s ``save_checkpoint_orbax``)
is refused by name: it is an OCDBT key-value store that only
tensorstore reads, which the card's machine lacks.
"""

from __future__ import annotations

import importlib
import json
import os
import shutil
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from gmf_tpu_torch.utils.flax_msgpack import read_msgpack

ORBAX_CONVERSION = ("from gmf_tpu.utils.checkpoint import load_checkpoint, "
                    "save_checkpoint; state, config = load_checkpoint(p); "
                    "save_checkpoint(p, state, config)")


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


def load_checkpoint(path: str) -> Tuple[Dict[str, Any], Optional[Dict]]:
    """(state, config dict or None) from the directory ``path``: the
    port's ``state_dict`` on the CPU from ``state.pt``, or ``gmf_tpu``'s
    tree from ``state.msgpack`` (module docstring; ``is_gmf_tree`` tells
    them apart). ``state.orbax`` alone raises ``ValueError``; a directory
    with none of them ``FileNotFoundError``."""
    pt, mp = (os.path.join(path, name) for name in ("state.pt",
                                                     "state.msgpack"))
    if os.path.exists(pt):
        state = torch.load(pt, map_location="cpu", weights_only=True)
    elif os.path.exists(mp):
        state = read_msgpack(mp)
    elif os.path.exists(os.path.join(path, "state.orbax")):
        raise ValueError(
            f"{path} holds state.orbax, gmf_tpu's Orbax checkpoint: Orbax's "
            "OCDBT store is not read by the port. Convert it to "
            "state.msgpack on a machine with gmf_tpu, in place (p the "
            f"directory): {ORBAX_CONVERSION}")
    else:
        raise FileNotFoundError(
            f"{path} holds no checkpoint: neither state.pt (the port's) nor "
            "state.msgpack (gmf_tpu's)")
    config = None
    cfg_path = os.path.join(path, "config.json")
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            config = json.load(f)
    return state, config


def is_gmf_tree(state) -> bool:
    """Whether ``state`` is ``gmf_tpu``'s tree (``{"params": {...}, ...}``)
    rather than the port's flat ``state_dict``."""
    return isinstance(state, dict) and isinstance(state.get("params"), dict)


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
