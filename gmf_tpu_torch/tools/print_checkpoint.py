"""Print a checkpoint: its tensors' names, shapes and types, its config.

Counterpart of ``gmf_tpu/tools/print_checkpoint.py`` (the reference's
GMF_DGR_fcgf/Test/Test.py checkpoint printing), for a port checkpoint
directory (``utils/checkpoint.py``) or a torch ``.pth``/``.pkl``:

    python -m gmf_tpu_torch.tools.print_checkpoint PATH [--max-leaves N]
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    """Print the checkpoint at PATH; returns (tensors, parameters)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("path")
    ap.add_argument("--max-leaves", type=int, default=200)
    args = ap.parse_args(argv)

    if os.path.isdir(args.path):
        from gmf_tpu_torch.utils.checkpoint import load_checkpoint

        sd, config = load_checkpoint(args.path)
        if config:
            print("config:", config)
        what = "leaves"
    else:
        from gmf_tpu_torch.utils.convert_torch import load_torch_state_dict

        sd = load_torch_state_dict(args.path)
        what = "tensors"
    total = 0
    for i, (name, v) in enumerate(sd.items()):
        total += v.numel()
        if i < args.max_leaves:
            print(f"{name}: {tuple(v.shape)} {v.dtype}")
    print(f"{len(sd)} {what}, {total / 1e6:.2f} M params")
    return len(sd), total


if __name__ == "__main__":
    main()
