"""Print a checkpoint: its tensors' names, shapes and types, its config.

Counterpart of ``gmf_tpu/tools/print_checkpoint.py`` (the reference's
GMF_DGR_fcgf/Test/Test.py checkpoint printing), for a checkpoint
directory (``utils/checkpoint.py``: the port's ``state.pt``, its tensors
by name, or ``gmf_tpu``'s ``state.msgpack``, its tree's leaves by path
as ``gmf_tpu`` prints them) or a torch ``.pth``/``.pkl``:

    python -m gmf_tpu_torch.tools.print_checkpoint PATH [--max-leaves N]
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def tree_leaves(tree, path=()):
    """(name, leaf) of a ``gmf_tpu`` tree in ``jax.tree_util``'s order
    (sorted keys), each name its keys as ``gmf_tpu``'s printer joins
    them: ``['params']/['encoder']/...``; a scalar leaf as a 0-d array."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from tree_leaves(tree[key], path + (key,))
    elif isinstance(tree, (list, tuple)):
        for i, item in enumerate(tree):
            yield from tree_leaves(item, path + (i,))
    elif tree is not None:
        name = "/".join(f"[{k!r}]" if isinstance(k, str) else f"[{k}]"
                        for k in path)
        yield name, tree if hasattr(tree, "shape") else np.asarray(tree)


def main(argv=None):
    """Print the checkpoint at PATH; returns (tensors, parameters)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("path")
    ap.add_argument("--max-leaves", type=int, default=200)
    args = ap.parse_args(argv)

    if os.path.isdir(args.path):
        from gmf_tpu_torch.utils.checkpoint import (is_gmf_tree,
                                                    load_checkpoint)

        sd, config = load_checkpoint(args.path)
        if config:
            print("config:", config)
        if is_gmf_tree(sd):
            sd = dict(tree_leaves(sd))
        what = "leaves"
    else:
        from gmf_tpu_torch.utils.convert_torch import load_torch_state_dict

        sd = load_torch_state_dict(args.path)
        what = "tensors"
    total = 0
    for i, (name, v) in enumerate(sd.items()):
        total += int(np.size(v)) if isinstance(v, np.ndarray) else v.numel()
        if i < args.max_leaves:
            print(f"{name}: {tuple(v.shape)} {v.dtype}")
    print(f"{len(sd)} {what}, {total / 1e6:.2f} M params")
    return len(sd), total


if __name__ == "__main__":
    main()
