"""The comparison that decides ``correct`` for the registration cells.

The program's answers are a transform and labels a pair; what the timed
path produced besides (the model's output dict: the seed hypotheses and
their fitness; for a sample of requests, the encoder's features) is taken
from it by hooks during the window. The plain reference
(``reference/pointdsc.py``) judges them after the window, request by
request, in five numbers.

On a sample of requests drawn from the seed over the window (the batch
cells: distinct entries of the pool):

- ``encoder_err``: the program's encoder features against the
  reference's own, computed from scratch in f64 on the same inputs and
  weights: per pair the relative Frobenius distance over valid rows, the
  largest over the pairs.
- ``seed_mismatch_share``: from the program's features, the reference's
  seed stage (confidence, NMS, kNN, spectral matching, Kabsch); the share
  of seed hypotheses that move some point of the pair's box by more than
  ``seed_tol`` of the box's size from the program's hypothesis of the same
  seed. Seed neighbourhoods that tie in rounding make a few such seeds in
  sound runs.
- ``e2e_trans_err_m``: the reference end to end, from its own f32
  features through its own seeds, hypotheses, choice and refinement,
  against the program's transform: the largest displacement of a corner
  of the pair's box, in metres. (Compared where the cell's limits name
  it: at KITTI's scale the f32 encoder's rounding alone moves sound runs
  about as far as the control.)

On every request:

- ``trans_err_m``: the reference counts the inliers of each of the
  program's hypotheses and starts from the program's winner where its
  count equals the best (an exact tie), else from the first best; it
  refines that start and compares the program's transform with it: the
  largest displacement of a corner of the pair's box, in metres.
- ``label_mismatch``: valid rows whose label differs from the residual of
  the reference's start under the inlier threshold.

The last two follow the program's hypotheses, so that every request is
judged at a cost the run can pay; the sampled requests are judged from
the inputs on as well.
"""

from __future__ import annotations

import torch

from perfbench.reference import pointdsc as ref


def box_corners(src, mask):
    """The 8 corners of each pair's box of valid source points [B, 8, 3]."""
    big = torch.finfo(torch.float32).max
    m = mask[..., None] > 0
    lo = torch.where(m, src, torch.full_like(src, big)).amin(1)
    hi = torch.where(m, src, torch.full_like(src, -big)).amax(1)
    c = torch.tensor([[i >> 2 & 1, i >> 1 & 1, i & 1] for i in range(8)],
                     dtype=src.dtype, device=src.device)
    return lo[:, None] + c[None] * (hi - lo)[:, None], (hi - lo).norm(dim=-1)


def displacement(Ta, Tb, corners):
    """Largest distance between Ta p and Tb p over the corners: Ta, Tb
    [B, ..., 4, 4], corners [B, 8, 3] -> [B, ...]. An affine map's largest
    displacement over a box lies at a corner."""
    extra = Ta.dim() - 3
    c = corners.reshape(corners.shape[:1] + (1,) * extra + corners.shape[1:])
    d = ref.apply(Ta, c) - ref.apply(Tb, c)
    return torch.sqrt((d * d).sum(-1)).amax(-1)


def _rows(B, rows, device):
    keep = torch.zeros(B, dtype=torch.bool, device=device)
    keep[slice(None) if rows is None else torch.as_tensor(rows)] = True
    return keep


def judge_answers(cfg, batch, out, rows=None):
    """``trans_err_m`` and ``label_mismatch`` of one request: ``out`` holds
    the program's seed_trans [B, S, 4, 4], seed_fitness [B, S],
    final_trans [B, 4, 4] and final_labels [B, N]; ``rows``, the rows
    that are answers (all by default; a service's flush also holds pad
    rows, which run in the batch but answer nobody)."""
    seed_trans = out["seed_trans"].float()
    counts = ref.inlier_counts(seed_trans, batch["src"], batch["tgt"],
                               batch["mask"], cfg["inlier_threshold"])
    chosen = out["seed_fitness"].float().argmax(-1)
    idx = torch.arange(counts.shape[0], device=counts.device)
    tie = counts[idx, chosen] == counts.amax(-1)
    start = torch.where(tie, chosen, counts.argmax(-1))
    res = ref.select_and_refine(cfg, seed_trans, batch, winner=start)
    corners, _ = box_corners(batch["src"], batch["mask"])
    keep = _rows(counts.shape[0], rows, counts.device)
    err = displacement(out["final_trans"].float(), res["final_trans"],
                       corners)[keep]
    valid = (batch["mask"] > 0) & keep[:, None]
    labels = out["final_labels"].float()
    mismatch = ((labels != res["labels"]) & valid).sum()
    gap = (counts.amax(-1) - counts[idx, chosen])[keep]
    return dict(trans_err_m=float(err.max()),
                label_mismatch=int(mismatch), pick_gap=int(gap.max()))


def encoder_error(W, cfg, batch, feats, keep, pairs_per_block):
    """Per pair, the relative Frobenius distance of ``feats`` from the
    reference's features in f64 over the pair's valid rows; the largest
    over the ``keep`` rows. (In f32 the encoder is ill-conditioned at
    KITTI's scale: the f32 reference lies up to 3e-2 from f64 by the
    largest element, so both sides are judged against f64.)"""
    W64 = {k: v.double() if v.is_floating_point() else v
           for k, v in W.items()}
    b64 = {k: v.double() for k, v in batch.items()}
    worst = 0.0
    for a in range(0, feats.shape[0], pairs_per_block):
        s = slice(a, a + pairs_per_block)
        want = ref.encode(W64, cfg, b64["corr_pos"][s], b64["src"][s],
                          b64["tgt"][s], b64["p_image"][s], b64["q_image"][s],
                          b64["mask"][s])
        valid = (batch["mask"][s] > 0)[..., None] & keep[s, None, None]
        diff = torch.where(valid, feats[s].double() - want, 0.0)
        norm = torch.where(valid, want, 0.0)
        err = diff.flatten(1).norm(dim=1) / norm.flatten(1).norm(dim=1)
        err = err[keep[s]]
        if err.numel():
            worst = max(worst, float(err.max()))
    return worst


def judge_stages(W, cfg, batch, out, feats, seed_tol, pairs_per_block,
                 rows=None):
    """``encoder_err``, ``seed_mismatch_share`` and ``e2e_trans_err_m`` of
    one request, from the program's features ``feats`` [B, N, C], seed
    hypotheses and transforms (of the answering ``rows``; all by
    default)."""
    keep = _rows(feats.shape[0], rows, feats.device)
    enc = encoder_error(W, cfg, batch, feats, keep, pairs_per_block)
    stage = ref.seed_stage(W, cfg, feats.float(), batch)
    corners, size = box_corners(batch["src"], batch["mask"])
    disp = displacement(out["seed_trans"].float(), stage["seed_trans"],
                        corners)[keep] / size[keep, None]
    del stage
    own = ref.seed_stage(W, cfg, ref.encode_blocks(W, cfg, batch,
                                                   pairs_per_block), batch)
    e2e = displacement(out["final_trans"].float(), own["final_trans"],
                       corners)[keep]
    return dict(encoder_err=enc,
                seed_mismatch_share=float((disp > seed_tol).float().mean()),
                e2e_trans_err_m=float(e2e.max()))


def control_outputs(W, cfg, batch, pairs_per_block):
    """The reference in TF32 put in the program's place: its features and
    the model's output dict, to be judged as the program's are."""
    with ref.products("tf32"):
        feats = ref.encode_blocks(W, cfg, batch, pairs_per_block)
        st = ref.seed_stage(W, cfg, feats, batch)
    out = dict(seed_trans=st["seed_trans"], seed_fitness=st["counts"].float(),
               final_trans=st["final_trans"], final_labels=st["labels"])
    return out, feats
