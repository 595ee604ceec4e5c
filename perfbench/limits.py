"""Readings that a cell's limits are set from, at the cell's own size.

    python3 perfbench/limits.py --workload <cell> --seeds 1,2,3
        [--seconds S] [--control-seeds 3] [--out FILE]

For each seed, one run of the cell as the benchmark makes it (its window
of ``--seconds``, its checks): the program's readings of every compared
number, and for the batch cells a second witness, the reference in f64,
on the sampled requests. For the first ``--control-seeds`` seeds, the
control besides: the plain reference computed with TF32 products (the
precision below the configuration's f32), put in the program's place and
judged by the same comparison on the same requests (the sampled
requests' stages, every request's answers); for the training cell also
the fault of half the batch left out. One JSON line a seed; the
benchmark's own runs do not run the control.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

T0 = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
os.environ["USE_FLAX"] = "0"

import numpy as np  # noqa: E402
import torch  # noqa: E402

from perfbench import harness, judge  # noqa: E402
from perfbench.reference import pointdsc as ref  # noqa: E402
from perfbench.reference import train as rtrain  # noqa: E402
from perfbench.traffic import generator  # noqa: E402
from perfbench.weights import make_weights  # noqa: E402


def _requests(cell, seed):
    """The batches a run of the cell judges: the pool's requests, or for a
    service the pool's pairs in flushes of ``max_batch``."""
    pool = generator.pool(cell.traffic, seed)
    if "max_batch" not in cell.cell:
        return pool
    pairs = [p for r in pool for p in r]
    per = cell.cell["max_batch"]
    groups = [pairs[i:i + per] for i in range(0, min(4 * per, len(pairs)),
                                               per)]
    # a flush is padded to max_batch with copies of its first pair
    return [g + [g[0]] * (per - len(g)) for g in groups]


def control_readings(cell, seed, device):
    """The control's readings for ``seed``: its stages on the requests a
    run samples, its answers on every request (batch cells)."""
    from perfbench.drivers.eval_batch import (READINGS, STAGE_READINGS,
                                              padded_batch, sample_plan)

    cfg = cell.config["model"]
    check = cell.cell["check"]
    W = make_weights(cfg, seed, device)
    requests = _requests(cell, seed)
    out = dict(READINGS)
    sampled = {key for _, key in sample_plan(seed, check, len(requests))}
    with torch.no_grad():
        for i, request in enumerate(requests):
            batch = padded_batch(request, cell.traffic["bucket"], device)
            got, feats = judge.control_outputs(W, cfg, batch,
                                               check["pairs_per_block"])
            a = judge.judge_answers(cfg, batch, got)
            out["trans_err_m"] = max(out["trans_err_m"], a["trans_err_m"])
            out["label_mismatch"] += a["label_mismatch"]
            if i in sampled:
                s = judge.judge_stages(W, cfg, batch, got, feats,
                                       check["seed_tol"],
                                       check["pairs_per_block"])
                for k in STAGE_READINGS:
                    out[k] = max(out[k], s[k])
            del got, feats
            torch.cuda.empty_cache()
    return out


def witness(cell, kept):
    """The f32 reference judged as the program is (against the reference
    in f64), beside the program's own reading, on the sampled requests."""
    cfg = cell.config["model"]
    ppb = cell.cell["check"]["pairs_per_block"]
    out = dict(program_vs_f64=0.0, reference_f32_vs_f64=0.0)
    with torch.no_grad():
        for batch, feats, W in kept:
            keep = torch.ones(feats.shape[0], dtype=torch.bool,
                              device=feats.device)
            f32 = ref.encode_blocks(W, cfg, batch, ppb)
            for key, f in (("program_vs_f64", feats),
                           ("reference_f32_vs_f64", f32)):
                out[key] = max(out[key], judge.encoder_error(
                    W, cfg, batch, f, keep, ppb))
    return out


def _train_gaps(got, want, W, names, moved):
    """Every training number's reading of (losses, first gradient,
    parameters after) ``got`` against ``want``, with the worst leaves."""
    from perfbench.drivers.train_step import leaf_gaps, norm_gap

    change = {k: got[2][k] - W[k] for k in names}
    want_change = {k: want[2][k] - W[k] for k in names}
    norms = {k: float(want_change[k].norm()) for k in moved}
    med = float(np.median(list(norms.values())))
    per_leaf = sorted(((abs(float(change[k].norm()) - norms[k])
                        / max(norms[k], med), k) for k in moved),
                      reverse=True)
    grads = sorted(((g, k) for k, g in leaf_gaps(got[1], want[1],
                                                  names).items()),
                   reverse=True)
    flat = [torch.cat([d[k].flatten() for k in names]) for d in (got[1],
                                                               want[1])]
    return dict(
        loss_gaps=[abs(a - b) / abs(b) for a, b in zip(got[0], want[0])],
        grad_gap=norm_gap(got[1], want[1], names), grad_worst=grads[:3],
        grad_gap_median_leaf=grads[len(grads) // 2][0],
        grad_gap_total=abs(float(flat[0].norm()) - float(flat[1].norm()))
        / float(flat[1].norm()),
        update_gap=per_leaf[0][0], update_worst=per_leaf[:3],
        update_gap_median_leaf=per_leaf[len(per_leaf) // 2][0])


def train_witness(cell, seed, kept, device):
    """The reference in f32 and in f64 from the same weights and batches:
    the program's and the f32 reference's readings against f64."""
    from perfbench.drivers.train_step import ref_batch

    cfg, tcfg = cell.config["model"], cell.config["train"]
    pool = generator.pool(cell.traffic, seed)
    first = cell.cell["first_steps"]
    W = kept["W"]
    batches = [ref_batch(pool[i], device) for i in range(first)]
    f32 = rtrain.train_steps(W, cfg, batches, tcfg["lr"],
                             tcfg["weight_decay"])
    W64 = {k: v.double() if v.is_floating_point() else v
           for k, v in W.items()}
    b64 = [{k: v.double() for k, v in b.items()} for b in batches]
    f64 = rtrain.train_steps(W64, cfg, b64, tcfg["lr"], tcfg["weight_decay"])
    f64 = (f64[0], {k: v.float() for k, v in f64[1].items()},
           {k: v.float() for k, v in f64[2].items()})
    names = list(f64[1])
    gnorm = {k: float(f64[1][k].norm()) for k in names}
    med = float(np.median(list(gnorm.values())))
    moved = [k for k in names if gnorm[k] >= 1e-3 * med]
    program = (kept["losses"], kept["grad1"],
               {k: W[k] + kept["change"][k] for k in names})
    return dict(program_vs_f64=_train_gaps(program, f64, W, names, moved),
                reference_f32_vs_f64=_train_gaps(f32, f64, W, names, moved),
                program_vs_f32=_train_gaps(program, f32, W, names, moved))


def train_readings(cell, seed, device):
    """The training cell's control (the reference in TF32) and its faults,
    judged as the program is against the reference in f32: half the batch
    left out (the reference on the first half, the mean taken over it);
    a state left unchanged (no update: the change is zero)."""
    from perfbench.drivers.train_step import readings, ref_batch

    cfg, tcfg = cell.config["model"], cell.config["train"]
    W = make_weights(cfg, seed, device)
    pool = generator.pool(cell.traffic, seed)
    first = cell.cell["first_steps"]
    batches = [ref_batch(pool[i], device) for i in range(first)]

    def steps(bs, mode="f32"):
        with ref.products(mode):
            return rtrain.train_steps(W, cfg, bs, tcfg["lr"],
                                      tcfg["weight_decay"])

    def judged(got):
        change = {k: got[2][k] - W[k] for k in got[2]}
        out = readings(got[0], got[1], change, want, W)
        names = list(want[1])
        gnorm = {k: float(want[1][k].norm()) for k in names}
        med = float(np.median(list(gnorm.values())))
        moved = [k for k in names if gnorm[k] >= 1e-3 * med]
        out["detail"] = _train_gaps(got, want, W, names, moved)
        return out

    want = steps(batches)
    half = [{k: v[:len(v) // 2] for k, v in b.items()} for b in batches]
    unchanged = (want[0], want[1], {k: W[k] for k in want[2]})
    return dict(control=judged(steps(batches, "tf32")),
                half_batch=judged(steps(half)), unchanged=judged(unchanged))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--out", default=None)
    ap.add_argument("--witness", action="store_true",
                    help="also the reference in f64 (a second witness)")
    args = ap.parse_args()
    cell = harness.Cell(harness.ROOT, args.workload)
    device = harness.open_device(cell.entry["chips"])
    if device is None:
        sys.exit("needs a CUDA device")
    seconds = args.seconds or cell.bench["run_seconds"]
    sink = open(args.out, "a") if args.out else None
    for n, seed in enumerate(int(s) for s in args.seeds.split(",")):
        run_args = harness.parse(["--workload", args.workload, "--seed",
                                  str(seed), "--seconds", str(seconds)])
        t0 = time.perf_counter()
        ctx = harness.Context(cell, run_args, t0, device)
        ctx.kept = [] if args.witness else None
        outcome = cell.driver.run(ctx)
        row = dict(workload=args.workload, seed=seed,
                   program={c["name"]: c["value"] for c in outcome.checks},
                   failed=outcome.failed, attempted=outcome.attempted,
                   notes=ctx.notes, e2e=outcome.e2e, setup_s=ctx.setup_s,
                   peak=outcome.memory_peak_bytes)
        if ctx.kept and cell.cell["driver"] == "train_step":
            row["witness"] = train_witness(cell, seed, ctx.kept[0], device)
        elif ctx.kept:
            row["witness"] = witness(cell, ctx.kept)
        del outcome
        ctx.kept = None
        ctx.free()
        if n < args.control_seeds:
            if cell.cell["driver"] == "train_step":
                row.update(train_readings(cell, seed, device))
            else:
                row["control"] = control_readings(cell, seed, device)
        row["seconds"] = time.perf_counter() - t0
        line = json.dumps(row)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()


if __name__ == "__main__":
    main()
