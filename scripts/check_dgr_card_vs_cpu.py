"""DGR's card-against-CPU checks over several pairs, measured on a card.

    python scripts/check_dgr_card_vs_cpu.py [--pairs 5] [--out PATH]

Needs one CUDA card; builds no kernel. Prints the card's name and power
limit, then runs chip_smoke.py's phase-8 check ``dgr_card_vs_cpu`` (the
same full-width random weights) on the pairs of seeds SEED + 20 onwards,
the first of them the pair that chip_smoke.py checks: FPFH's parts and
features (``dgr_fpfh_card_vs_cpu``), then ``register`` for fcgf, fpfh
and fpfh with ICP on the default path (kernel maps built on the device,
the compacted inlier convolution) on the card and the same config on the
CPU, and each pair's pyramids (``dgr_pyramid_checks``: the card's device
pyramids equal to the CPU's and to the native builder's). A check that
fails is reported and the run goes on, so that the readings behind
chip_smoke.py's bounds show in full.

The last line is a JSON object with every row and every failed check.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
from gmf_tpu_torch.utils.device import resolve_device  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--pairs", type=int, default=5)
    ap.add_argument("--out", help="also write the result JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("check_dgr_card_vs_cpu: needs a CUDA card")
    failed = []

    def report(msg):
        failed.append(msg)
        print(f"check_dgr_card_vs_cpu: FAIL: {msg}", flush=True)

    chip_smoke.fail = report
    print(chip_smoke.nvidia_smi("name,power.limit"), flush=True)
    dev = resolve_device("cuda")
    torch.set_num_threads(8)
    nets = chip_smoke.dgr_nets()
    rows = [dict(seed=f"SEED + {20 + i}", **chip_smoke.dgr_card_vs_cpu(
        dev, nets, chip_smoke.SEED + 20 + i)) for i in range(args.pairs)]
    result = dict(rows=rows, failed=failed)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
