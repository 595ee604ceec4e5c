"""Plant faults in the flash-attention backward on the card and show that
chip_smoke.py's f32 train-step check catches each one.

    python scripts/check_train_faults.py [--compat-cache auto off]

For each ``compat_cache`` mode: chip_smoke.py's full-width f32 trainer
(16 pairs of N=1000) and its CPU reference steps (f64, and f32 at 8 and 4
threads) once, then one step on the card per case, each on a fresh copy
of the same initial model, held to chip_smoke.compare_train_step's
bounds. The cases: the kernels as they are, which must pass, and the
backward's result altered after its kernels ran, which must each fail:
dQ zeroed, dK and dV swapped, dQ scaled by 1.01, dV scaled by 1.01.
Prints one JSON line per case, exits 1 if any case comes out otherwise.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
from pathlib import Path
from unittest import mock

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

FAULTS = {
    "none": None,
    "dq_zeroed": lambda dq, dk, dv: (torch.zeros_like(dq), dk, dv),
    "dk_dv_swapped": lambda dq, dk, dv: (dq, dv, dk),
    "dq_times_1.01": lambda dq, dk, dv: (dq * 1.01, dk, dv),
    "dv_times_1.01": lambda dq, dk, dv: (dq, dk, dv * 1.01),
}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--compat-cache", nargs="+", default=["auto", "off"],
                    choices=("auto", "off", "f32", "bf16", "int8"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")

    import chip_smoke
    from gmf_tpu_torch.ops import fused_attention
    from gmf_tpu_torch.utils.device import resolve_device

    dev = resolve_device("cuda")  # also keeps TF32 off for f32 products
    print(chip_smoke.nvidia_smi("name,power.limit"), flush=True)
    bwd = fused_attention.compat_flash_attention_bwd
    wrong = 0
    for mode in args.compat_cache:
        trainer = chip_smoke.make_trainer(dev, mode)
        batch = next(iter(trainer.train_loader))
        initial = copy.deepcopy(trainer.model)
        cpu_runs = chip_smoke.cpu_reference_steps(initial, batch, mode)
        for case, fault in FAULTS.items():
            def planted(*a, fault=fault, **kw):
                return fault(*bwd(*a, **kw))

            model = copy.deepcopy(initial)
            with mock.patch.object(fused_attention,
                                   "compat_flash_attention_bwd",
                                   bwd if fault is None else planted):
                out = chip_smoke.compare_train_step(model, batch, cpu_runs)
            expected = fault is None
            wrong += out["ok"] != expected
            print(json.dumps({"compat_cache": mode, "fault": case,
                              "caught": not out["ok"],
                              "as_expected": out["ok"] == expected,
                              **{k: v for k, v in out.items()
                                 if k != "cpu_step_seconds"}}), flush=True)
            del model
            torch.cuda.empty_cache()
        del trainer, initial, cpu_runs
    sys.exit(1 if wrong else 0)


if __name__ == "__main__":
    main()
