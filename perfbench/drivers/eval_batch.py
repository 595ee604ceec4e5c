"""Closed-loop batch registration: back-to-back
``PointDSCRegistrar.register_batch`` calls of a mix's requests.

Set-up makes the weights on the device from the seed, builds the model in
the configuration's modes behind a registrar with the mix's one bucket,
makes the pool of requests, and serves ``warmup_requests`` of them. The
window then serves the pool's requests in turn until ``--seconds`` have
passed; every call returns host arrays, so each ends synchronised, and
the rate is the pairs of every finished call over the time to the end of
the last one. Hooks keep what the model returned for every request and
the encoder's features of a sample of requests drawn from the seed; after
the window the reference judges them (``judge.py``).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from perfbench import judge
from perfbench.harness import Outcome, check_value
from perfbench.tracing import Trace, span, traced
from perfbench.traffic import generator
from perfbench.weights import make_weights

MODEL_KEYS = ("in_dim", "num_layers", "num_channels", "num_iterations",
              "ratio", "inlier_threshold", "sigma_d", "k", "nms_radius")
STAGE_READINGS = ("encoder_err", "seed_mismatch_share", "e2e_trans_err_m")
READINGS = dict(encoder_err=0.0, seed_mismatch_share=0.0, e2e_trans_err_m=0.0,
                trans_err_m=0.0, label_mismatch=0)
MODE_KEYS = ("compat_cache", "seed_solver", "fused_attention", "knn_topk",
             "hypo_scoring", "kabsch_method")


def build_model(ctx, W):
    """The program's model in the configuration's modes, with ``W``."""
    from gmf_tpu_torch.models import PointDSC

    cfg = ctx.config
    model = PointDSC(**{k: cfg["model"][k] for k in MODEL_KEYS},
                     **{k: cfg["modes"][k] for k in MODE_KEYS},
                     dtype=torch.float32, device=ctx.device)
    model.load_state_dict(W, strict=True)
    return model


def padded_batch(samples, bucket, device):
    """A request as the reference takes it: rows zero-padded to
    ``bucket``, a mask of the valid ones."""
    def stack(key, rows=True):
        out = []
        for s in samples:
            a = np.asarray(s[key], np.float32)
            if rows:
                z = np.zeros((bucket,) + a.shape[1:], np.float32)
                z[:len(a)] = a
                a = z
            out.append(a)
        return torch.from_numpy(np.stack(out)).to(device)

    mask = np.stack([(np.arange(bucket) < len(s["labels"])).astype(
        np.float32) for s in samples])
    return dict(corr_pos=stack("corr_pos"), src=stack("src_keypts"),
                tgt=stack("tgt_keypts"), mask=torch.from_numpy(mask).to(
                    device),
                p_image=stack("p_image", False),
                q_image=stack("q_image", False))


def answers(results, bucket, device):
    """The registrar's answers as the judge takes them: transforms
    [B, 4, 4] and labels zero-padded to [B, bucket]."""
    trans = np.stack([t for t, _ in results]).astype(np.float32)
    labels = np.zeros((len(results), bucket), np.float32)
    for i, (_, lab) in enumerate(results):
        labels[i, :len(lab)] = lab
    return (torch.from_numpy(trans).to(device),
            torch.from_numpy(labels).to(device))


def malformed(request, result):
    """Pairs of a request whose answer is missing or malformed."""
    if len(result) != len(request):
        return len(request)
    bad = 0
    for s, (trans, labels) in zip(request, result):
        bad += not (np.shape(trans) == (4, 4) and np.isfinite(trans).all()
                    and np.shape(labels) == (len(s["labels"]),))
    return bad


def sample_plan(seed, check, keys=None):
    """The requests whose encoder features the check compares, drawn from
    the seed: for each, a point of the window (a share of its seconds
    under ``sample_within``) and, where the requests come from a pool of
    ``keys`` entries, which entry (distinct entries, drawn without
    replacement). The first request at or after its point (of its entry)
    is sampled. [(share, key or None)] in the order of their points."""
    rng = np.random.default_rng([seed, 3])
    count = check["sample_requests"]
    if keys is not None:
        count = min(count, keys)
        picked = rng.choice(keys, count, replace=False).tolist()
    else:
        picked = [None] * count
    shares = np.sort(rng.random(count)) * check["sample_within"]
    return list(zip(shares.tolist(), picked))


class Sampler:
    """Picks the sampled requests during the window by ``sample_plan``."""

    def __init__(self, plan, seconds, keys=None):
        self.plan, self.seconds, self.keys = plan, seconds, keys
        self.taken = set()
        self.t0 = None

    def start(self, t0):
        self.t0 = t0

    def wants(self, index):
        """Whether request ``index`` of the window is sampled."""
        if self.t0 is None:
            return False
        now = time.perf_counter() - self.t0
        for j, (share, key) in enumerate(self.plan):
            if j in self.taken or now < share * self.seconds:
                continue
            if key is None or index % self.keys == key:
                self.taken.add(j)
                return True
        return False

    @property
    def missed(self):
        return len(self.plan) - len(self.taken)


def run(ctx) -> Outcome:
    from gmf_tpu_torch.eval.registration import PointDSCRegistrar

    cell, mix, check = ctx.cell, ctx.traffic, ctx.cell["check"]
    model_cfg = ctx.config["model"]
    ctx.phase("imports")
    W = make_weights(model_cfg, ctx.seed, ctx.device)
    ctx.phase("weights")
    model = build_model(ctx, W)
    reg = PointDSCRegistrar(model, buckets=(mix["bucket"],))
    ctx.phase("model")
    pool = generator.pool(mix, ctx.seed)
    ctx.phase("traffic")
    for i in range(cell["warmup_requests"]):
        reg.register_batch(pool[i % len(pool)])
    ctx.sync()

    seconds = ctx.window_seconds()
    sampler = Sampler(sample_plan(ctx.seed, check, len(pool)), seconds,
                      len(pool))
    outputs, feats, calls = [], {}, [0]

    def keep_output(mod, args, out):
        outputs.append({k: out[k] for k in ("seed_trans", "seed_fitness")})
        calls[0] += 1

    def keep_features(mod, args, out):
        if sampler.wants(calls[0]):
            feats[calls[0]] = out

    hooks = [model.register_forward_hook(keep_output),
             model.encoder.register_forward_hook(keep_features)]
    trace = Trace()
    results = []
    ctx.setup_done()
    with traced(trace, ctx.trace, model):
        t0 = time.perf_counter()
        sampler.start(t0)
        while True:
            request = pool[len(results) % len(pool)]
            with span("perfbench.register_batch", ctx.trace):
                results.append(reg.register_batch(request))
            if time.perf_counter() - t0 >= seconds:
                break
        elapsed = time.perf_counter() - t0
    for h in hooks:
        h.remove()
    peak = ctx.memory_peak()
    del reg, model
    ctx.free()

    requests = [pool[i % len(pool)] for i in range(len(results))]
    pairs = sum(len(r) for r in requests)
    failed = sum(malformed(q, r) for q, r in zip(requests, results))
    readings = dict(READINGS)
    batches = {}
    for i, (request, result) in enumerate(zip(requests, results)):
        if malformed(request, result):
            continue
        key = i % len(pool)
        if key not in batches:
            batches[key] = padded_batch(request, mix["bucket"], ctx.device)
        batch = batches[key]
        trans, labels = answers(result, mix["bucket"], ctx.device)
        out = dict(outputs[i], final_trans=trans, final_labels=labels)
        got = judge.judge_answers(model_cfg, batch, out)
        readings["trans_err_m"] = max(readings["trans_err_m"],
                                      got["trans_err_m"])
        readings["label_mismatch"] += got["label_mismatch"]
        ctx.notes["pick_gap"] = max(ctx.notes.get("pick_gap", 0),
                                    got["pick_gap"])
        if i in feats:
            if ctx.kept is not None:  # a tool's look at what was judged
                ctx.kept.append((batch, feats[i], W))
            got = judge.judge_stages(W, model_cfg, batch, out, feats.pop(i),
                                     check["seed_tol"],
                                     check["pairs_per_block"])
            for k in STAGE_READINGS:
                readings[k] = max(readings[k], got[k])
    failed += sampler.missed  # a sampled request that never ran
    checks = [check_value(k, v, cell["limits"][k])
              for k, v in readings.items() if k in cell["limits"]]
    trace.counts = dict(pairs=sum(len(pool[i % len(pool)])
                                  for i in range(len(trace.forwards))),
                        requests=len(trace.forwards))
    trace.work = dict(config=model_cfg, bucket=mix["bucket"],
                      image_hw=mix["image_hw"],
                      valid=[[len(s["labels"]) for s in pool[i % len(pool)]]
                             for i in range(len(trace.forwards))])
    return Outcome(attempted=pairs, failed=failed,
                   e2e={"pairs_per_s": pairs / elapsed}, checks=checks,
                   trace=trace, memory_peak_bytes=peak)
