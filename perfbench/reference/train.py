"""Plain PyTorch reference of a PointDSC training step, f32: the train
branch of ``pointdsc.py``, the published losses (GMF_PointDSC
``libs/loss.py``: the balanced classification loss and the balanced
spectral-matching loss; the transformation loss has weight 0 in the
3DMatch configuration and is left out), gradients by autograd, and Adam
with the weight decay added to the gradient (``torch.optim.Adam``'s
rule, written out).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from perfbench.reference import pointdsc as ref

BUFFERS = ("running_mean", "running_var", "num_batches_tracked")


def is_parameter(name: str) -> bool:
    return not name.endswith(BUFFERS)


def classification_loss(logits, labels):
    """BCE with logits, the positives weighted by #negatives / #positives
    (each count floored as relu(x - 1) + 1), the mean over every entry."""
    num_pos = F.relu(labels.sum() - 1.0) + 1.0
    num_neg = F.relu((1.0 - labels).sum() - 1.0) + 1.0
    per = -(num_neg / num_pos * labels * F.logsigmoid(logits)
            + (1.0 - labels) * F.logsigmoid(-logits))
    return per.mean()


def spectral_matching_loss(M, labels):
    """Half the mean of (M - 1)^2 over inlier pairs, half the mean of M^2
    over the other cells (the diagonal counted among them), per pair,
    then the batch mean."""
    N = labels.shape[-1]
    gt = labels[:, None, :] * labels[:, :, None]
    gt = gt * (1.0 - torch.eye(N, device=M.device))
    pos = ((M - 1.0) ** 2 * gt).sum((-2, -1))
    npos = F.relu(gt.sum((-2, -1)) - 1.0) + 1.0
    neg_mask = 1.0 - gt
    neg = (M ** 2 * neg_mask).sum((-2, -1))
    nneg = F.relu(neg_mask.sum((-2, -1)) - 1.0) + 1.0
    return (0.5 * pos / npos + 0.5 * neg / nneg).mean()


def loss_of(W, cfg, batch):
    out = ref.train_forward(W, cfg, batch)
    return (classification_loss(out["final_labels"], batch["labels"])
            + spectral_matching_loss(out["M"], batch["labels"]))


class Adam:
    def __init__(self, lr, weight_decay, betas=(0.9, 0.999), eps=1e-8):
        self.lr, self.wd, self.betas, self.eps = lr, weight_decay, betas, eps
        self.m, self.v, self.t = {}, {}, 0

    def step(self, params, grads):
        """Update ``params`` in place; returns the gradients as Adam took
        them (weight decay added)."""
        b1, b2 = self.betas
        self.t += 1
        taken = {}
        for k, p in params.items():
            g = grads[k] + self.wd * p
            taken[k] = g
            m = self.m.get(k, torch.zeros_like(p)) * b1 + (1 - b1) * g
            v = self.v.get(k, torch.zeros_like(p)) * b2 + (1 - b2) * g * g
            self.m[k], self.v[k] = m, v
            m_hat = m / (1 - b1 ** self.t)
            v_hat = v / (1 - b2 ** self.t)
            p -= self.lr * m_hat / (torch.sqrt(v_hat) + self.eps)
        return taken


def train_steps(W0, cfg, batches, lr, weight_decay):
    """Steps of the reference from weights ``W0`` on ``batches``: (losses,
    the first step's gradients as Adam took them, the parameters after
    the last step), per parameter name."""
    W = {k: v.detach().clone() for k, v in W0.items()}
    params = {k: v for k, v in W.items() if is_parameter(k)}
    opt = Adam(lr, weight_decay)
    losses, first = [], None
    for batch in batches:
        for p in params.values():
            p.requires_grad_(True)
        loss = loss_of(W, cfg, batch)
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(params.items(), grads)}
        losses.append(loss.item())
        with torch.no_grad():
            for p in params.values():
                p.requires_grad_(False)
            taken = opt.step(params, grads)
        if first is None:
            first = taken
    return losses, first, params
