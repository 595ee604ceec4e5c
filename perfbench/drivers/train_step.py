"""Training: ``Trainer.train_step`` on a mix's batches, back to back.

Set-up builds one ``Trainer`` (the model in the configuration's modes,
weights made on the device from the seed, the configuration's Adam), and
drives it through its first ``first_steps`` steps on distinct batches of
the pool, through the same call the window makes. It keeps the loss of
each, the first gradient as Adam took it (from Adam's state after step
one) and the parameters after the last. The window then takes steps on
the pool's batches in turn until ``--seconds`` have passed; each returns
host floats, so each ends synchronised. The rate is the pairs of every
applied step over the time to the end of the last; a skipped step or a
non-finite loss counts as failed.

After the window the reference (``reference/train.py``) takes the same
first steps from the same weights on the same batches. Compared:

- ``first_loss_gap``: the first step's loss, the gap over the
  reference's. (The later steps' losses part by up to 2e-2 in f32 on
  both sides: the reference in f32 lies as far from itself in f64. Adam's
  first steps move each element by about the learning rate whatever the
  size of its gradient, so rounding that flips an element's small
  gradient moves the parameters, and the next losses.)
- ``grad_gap``: the norm of the first gradient as Adam took it, by the
  worst leaf: the gap between the program's norm and the reference's,
  over the reference's norm of the leaf or of the median leaf, whichever
  is larger.
- ``median_update_gap``: the same gap for the change of the parameters
  over the first steps, at the median leaf (the worst leaf, a small bias
  of the attention projections under Adam, reads up to 0.4 in f32 on both
  sides for the same cause). Leaves whose reference gradient is under a
  thousandth of the median leaf's (biases that a batch norm cancels:
  their gradient is rounding) are left out.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from perfbench.drivers.eval_batch import build_model
from perfbench.harness import Outcome, check_value
from perfbench.reference import train as rtrain
from perfbench.tracing import Trace, span, traced
from perfbench.traffic import generator
from perfbench.weights import make_weights

KEYS = ("corr_pos", "src_keypts", "tgt_keypts", "labels", "gt_trans",
        "p_image", "q_image")


def host_batch(pairs):
    return {k: np.stack([p[k] for p in pairs]) for k in KEYS}


def ref_batch(pairs, device):
    b = host_batch(pairs)
    t = {k: torch.from_numpy(v).to(device) for k, v in b.items()}
    return dict(corr_pos=t["corr_pos"], src=t["src_keypts"],
                tgt=t["tgt_keypts"], labels=t["labels"],
                mask=torch.ones_like(t["labels"]), p_image=t["p_image"],
                q_image=t["q_image"])


def leaf_gaps(got, want, keep):
    """Per leaf, the gap between the norms of ``got`` and ``want`` over
    the reference's norm of the leaf or of the median leaf."""
    norms = {k: float(want[k].norm()) for k in keep}
    median = float(np.median(list(norms.values())))
    return {k: abs(float(got[k].norm()) - norms[k]) / max(norms[k], median)
            for k in keep}


def norm_gap(got, want, keep):
    """The worst leaf's ``leaf_gaps``."""
    return max(leaf_gaps(got, want, keep).values())


def median_gap(got, want, keep):
    """The median leaf's ``leaf_gaps``."""
    return float(np.median(list(leaf_gaps(got, want, keep).values())))


def readings(losses, grad1, change, want, W):
    """The compared numbers of (losses, first gradient, change over the
    first steps) against the reference's ``want`` = (losses, first
    gradient, parameters after)."""
    ref_losses, ref_grad1, ref_params = want
    names = list(ref_grad1)
    gnorm = {k: float(ref_grad1[k].norm()) for k in names}
    med = float(np.median(list(gnorm.values())))
    moved = [k for k in names if gnorm[k] >= 1e-3 * med]
    ref_change = {k: ref_params[k] - W[k] for k in names}
    return dict(
        first_loss_gap=abs(losses[0] - ref_losses[0]) / abs(ref_losses[0]),
        grad_gap=norm_gap(grad1, ref_grad1, names),
        median_update_gap=median_gap(change, ref_change, moved))


def run(ctx) -> Outcome:
    from gmf_tpu_torch.train.trainer import TrainConfig, Trainer

    cell, mix = ctx.cell, ctx.traffic
    model_cfg, train_cfg = ctx.config["model"], ctx.config["train"]
    ctx.phase("imports")
    W = make_weights(model_cfg, ctx.seed, ctx.device)
    ctx.phase("weights")
    model = build_model(ctx, W)
    tcfg = TrainConfig(lr=train_cfg["lr"],
                       weight_decay=train_cfg["weight_decay"],
                       batch_size=mix["pairs_per_request"])
    # one epoch is longer than any run: the rate stays the configuration's
    trainer = Trainer(model, tcfg, None, None, steps_per_epoch=10 ** 9)
    ctx.phase("model")
    batches = [host_batch(p) for p in generator.pool(mix, ctx.seed)]
    ctx.phase("traffic")
    first = cell["first_steps"]
    p0 = {k: p.detach().clone() for k, p in model.named_parameters()}
    losses, grad1, bad = [], None, 0
    for i in range(first):
        m = trainer.train_step(batches[i], epoch=1)
        losses.append(m["loss"])
        bad += m["skipped_step"] != 0.0 or not math.isfinite(m["loss"])
        if i == 0:
            beta1 = trainer.optimizer.param_groups[0]["betas"][0]
            # Adam's first moment after one step is (1 - beta1) times
            # the gradient it took (none: it took no step)
            grad1 = {k: trainer.optimizer.state[p].get(
                "exp_avg", torch.zeros_like(p)) / (1 - beta1)
                for k, p in model.named_parameters()}
    p_first = {k: p.detach().clone() for k, p in model.named_parameters()}
    ctx.phase("first steps")
    if ctx.kept is not None:  # a tool's look at what was judged
        ctx.kept.append(dict(losses=losses, grad1=grad1, W=W,
                             change={k: p_first[k] - p0[k] for k in p0}))

    trace = Trace()
    seconds = ctx.window_seconds()
    steps, failed = 0, 0
    ctx.setup_done()
    with traced(trace, ctx.trace, None):
        t0 = time.perf_counter()
        while True:
            with span("perfbench.train_step", ctx.trace):
                m = trainer.train_step(
                    batches[(first + steps) % len(batches)], epoch=1)
            steps += 1
            failed += m["skipped_step"] != 0.0 or not math.isfinite(m["loss"])
            if time.perf_counter() - t0 >= seconds:
                break
        elapsed = time.perf_counter() - t0
    peak = ctx.memory_peak()
    del trainer, model
    ctx.free()

    pairs = mix["pairs_per_request"]
    ref_losses, ref_grad1, ref_params = rtrain.train_steps(
        W, model_cfg, [ref_batch(generator.pool(mix, ctx.seed)[i],
                                 ctx.device) for i in range(first)],
        train_cfg["lr"], train_cfg["weight_decay"])
    change = {k: p_first[k] - p0[k] for k in p0}
    got = readings(losses, grad1, change,
                   (ref_losses, ref_grad1, ref_params), W)
    checks = [check_value(k, v, cell["limits"][k]) for k, v in got.items()]
    trace.counts = dict(steps=steps if ctx.trace else 0, pairs=pairs)
    trace.work = dict(config=model_cfg, pairs=pairs, n=mix["bucket"],
                      image_hw=mix["image_hw"])
    return Outcome(attempted=steps, failed=failed + bad,
                   e2e={"train_pairs_per_s": (steps - failed) * pairs /
                        elapsed},
                   checks=checks, trace=trace, memory_peak_bytes=peak)
