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

``save_gmf_checkpoint`` writes such a directory the way ``gmf_tpu``'s
``save_checkpoint`` does, byte for byte: ``state.msgpack`` of the tree
(``utils/model_io.py::state_dict_to_tree`` makes one from a model) and
the same ``config.json``; ``gmf_tpu`` loads what it writes.
"""

from __future__ import annotations

import importlib
import json
import os
import shutil
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from gmf_tpu_torch.utils.flax_msgpack import read_msgpack, write_msgpack

# what the writers that have a gmf_tpu counterpart can write: the port's
# state.pt, or gmf_tpu's state.msgpack
CHECKPOINT_FORMATS = ("pt", "gmf")
ORBAX_CONVERSION = ("from gmf_tpu.utils.checkpoint import load_checkpoint, "
                    "save_checkpoint; state, config = load_checkpoint(p); "
                    "save_checkpoint(p, state, config)")


def _write_config(path: str, config: Optional[Dict[str, Any]]):
    if config is not None:
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump(config, f, indent=2, default=str)


def save_checkpoint(path: str, state_dict: Dict[str, torch.Tensor],
                    config: Optional[Dict[str, Any]] = None) -> str:
    """Write ``state_dict`` (and ``config``) to the directory ``path``."""
    os.makedirs(path, exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()},
               os.path.join(path, "state.pt"))
    _write_config(path, config)
    return path


def _as_arrays(tree):
    """``jax.tree.map(np.asarray, tree)``: every leaf but None an array
    (a tensor stays one: the writer copies it to the host)."""
    if isinstance(tree, dict):
        return {k: _as_arrays(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_as_arrays(v) for v in tree)
    if tree is None or isinstance(tree, torch.Tensor):
        return tree
    return np.asarray(tree)


def save_gmf_checkpoint(path: str, tree: Dict[str, Any],
                        config: Optional[Dict[str, Any]] = None) -> str:
    """Write ``tree`` (and ``config``) to the directory ``path`` as
    ``gmf_tpu``'s ``save_checkpoint`` writes them: ``state.msgpack``
    (flax's msgpack of the tree, every leaf an array) and ``config.json``
    (``json.dump(config, indent=2, default=str)``)."""
    os.makedirs(path, exist_ok=True)
    write_msgpack(os.path.join(path, "state.msgpack"), _as_arrays(tree))
    _write_config(path, config)
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
