"""Open-loop serving: single pairs submitted to ``RegistrationService`` on
a Poisson schedule.

Set-up makes the weights on the device from the seed, builds the model in
the configuration's modes behind a registrar with the mix's bucket and a
``RegistrationService`` with the cell's ``max_batch``, ``max_wait_ms`` and
``inflight``, runs the service's own warm-up, and makes the pool of pairs
and the schedule. In the window one client thread submits each pair when
it is due, whether or not earlier ones have finished; a request's latency
runs from when it was due to when its result was set. After the last
arrival the run waits for every request (a minute at most); one that
fails or never comes counts as failed and as missing every latency limit.

The benchmark wraps the registrar's ``dispatch_batch`` to keep each
flush's pairs (the service pads a flush to ``max_batch`` with copies of
its first pair), and hooks keep what the model returned for each flush
and the encoder's features of a sample of flushes drawn from the seed
over the window.
After the window the reference judges every flush's real rows as the
batch cells' are judged (``judge.py``), on the batch the flush ran.
"""

from __future__ import annotations

import time

import numpy as np

from perfbench import judge
from perfbench.drivers.eval_batch import (READINGS, STAGE_READINGS, Sampler,
                                          answers, build_model, padded_batch,
                                          sample_plan)
from perfbench.harness import Outcome, check_value
from perfbench.tracing import Trace, traced
from perfbench.traffic import generator
from perfbench.weights import make_weights

WAIT_AFTER_S = 60.0


def serve(svc, pairs, due, t0):
    """Submit ``pairs[i]`` at ``t0 + due[i]`` from this thread; returns
    per request [submitted dict, future, finish time box] and the
    generator's largest lateness."""
    sent, late = [], 0.0
    for pair, at in zip(pairs, due):
        wait = t0 + at - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        late = max(late, time.perf_counter() - (t0 + at))
        sample = dict(pair)
        box = []
        fut = svc.submit(sample)
        fut.add_done_callback(lambda f, b=box: b.append(time.perf_counter()))
        sent.append((sample, fut, box))
    return sent, late


def run(ctx) -> Outcome:
    from gmf_tpu_torch.eval.registration import PointDSCRegistrar
    from gmf_tpu_torch.eval.serving import RegistrationService

    cell, mix, check = ctx.cell, ctx.traffic, ctx.cell["check"]
    model_cfg = ctx.config["model"]
    ctx.phase("imports")
    W = make_weights(model_cfg, ctx.seed, ctx.device)
    ctx.phase("weights")
    model = build_model(ctx, W)
    reg = PointDSCRegistrar(model, buckets=(mix["bucket"],))
    ctx.phase("model")
    pairs = [p for request in generator.pool(mix, ctx.seed) for p in request]
    ctx.phase("traffic")
    seconds = ctx.window_seconds()
    due = generator.arrivals(mix, ctx.seed, seconds, cell.get("rate"))
    schedule = [pairs[i % len(pairs)] for i in range(len(due))]
    svc = RegistrationService(reg, max_batch=cell["max_batch"],
                              max_wait_ms=cell["max_wait_ms"],
                              inflight=cell["inflight"])
    svc.warmup([mix["bucket"]], image_hw=tuple(mix["image_hw"]))

    flushes, outputs, feats = [], [], {}
    sampler = Sampler(sample_plan(ctx.seed, check), seconds)
    dispatch = reg.dispatch_batch

    def recording(samples):
        flushes.append(list(samples))
        return dispatch(samples)

    def keep_output(mod, args, out):
        outputs.append({k: out[k] for k in ("seed_trans", "seed_fitness")})

    def keep_features(mod, args, out):
        if sampler.wants(len(outputs)):
            feats[len(outputs)] = out

    reg.dispatch_batch = recording
    hooks = [model.register_forward_hook(keep_output),
             model.encoder.register_forward_hook(keep_features)]
    trace = Trace()
    ctx.setup_done()
    with traced(trace, ctx.trace, None):
        t0 = time.perf_counter()
        sampler.start(t0)
        sent, late = serve(svc, schedule, due, t0)
        for _, fut, _ in sent:
            try:
                fut.result(timeout=max(0.0, t0 + seconds + WAIT_AFTER_S
                                       - time.perf_counter()))
            except Exception:
                pass
    svc.close(timeout=WAIT_AFTER_S)
    for h in hooks:
        h.remove()
    reg.dispatch_batch = dispatch
    peak = ctx.memory_peak()
    del svc, reg, model
    ctx.free()

    latency, failed, result = [], 0, {}
    for (sample, fut, box), at in zip(sent, due):
        ok = fut.done() and fut.exception() is None and box
        if ok:
            trans, labels = fut.result()
            ok = (np.shape(trans) == (4, 4) and np.isfinite(trans).all()
                  and np.shape(labels) == (len(sample["labels"]),))
        if ok:
            latency.append(box[0] - (t0 + at))
            result[id(sample)] = fut.result()
        else:  # never came: it waited at least until the run gave up
            failed += 1
            latency.append(time.perf_counter() - (t0 + at))
    lat_ms = 1e3 * np.asarray(latency)

    readings = dict(READINGS)
    real_rows = []
    for i, samples in enumerate(flushes[:len(outputs)]):
        rows = [j for j, s in enumerate(samples) if id(s) in result]
        real_rows.append(len(rows))
        if not rows:
            continue
        batch = padded_batch(samples, mix["bucket"], ctx.device)
        trans, labels = answers(
            [result.get(id(s), result[id(samples[rows[0]])])
             for s in samples], mix["bucket"], ctx.device)
        out = dict(outputs[i], final_trans=trans, final_labels=labels)
        got = judge.judge_answers(model_cfg, batch, out, rows=rows)
        readings["trans_err_m"] = max(readings["trans_err_m"],
                                      got["trans_err_m"])
        readings["label_mismatch"] += got["label_mismatch"]
        ctx.notes["pick_gap"] = max(ctx.notes.get("pick_gap", 0),
                                    got["pick_gap"])
        if i in feats:
            got = judge.judge_stages(W, model_cfg, batch, out, feats.pop(i),
                                     check["seed_tol"],
                                     check["pairs_per_block"], rows=rows)
            for k in STAGE_READINGS:
                readings[k] = max(readings[k], got[k])
    failed += sampler.missed  # a sampled flush that never ran
    checks = [check_value(k, v, cell["limits"][k])
              for k, v in readings.items() if k in cell["limits"]]
    done = [box[0] for _, _, box in sent if box]
    trace.counts = dict(flushes=len(real_rows), pairs=sum(real_rows),
                        generator_late_s=late, latency_ms=lat_ms.tolist(),
                        completed_per_s=len(done) / max(
                            1e-9, max(done, default=t0) - t0))
    return Outcome(attempted=len(sent), failed=failed,
                   e2e={"latency_p95_ms": float(np.percentile(
                       lat_ms, 95, method="higher"))},
                   checks=checks, trace=trace, memory_peak_bytes=peak)
