"""Plain PyTorch reference of PointDSC+GMF, f32, for the benchmark's checks.

Written from the published model (GMF_PointDSC: ``models/PointDSC.py``,
``models/common.py``, the GMF fusion layers, a torchvision ResNet-34 cut
after layer2) as functions of a weights dict whose keys are the
reference's torch module names. It imports nothing of the program under
test: the benchmark makes the weights and the inputs and hands the same
to both sides.

Every product goes through ``_p``, so that ``products("tf32")`` (the
check's control) rounds each operand to TF32, as the card's tensor cores
do with TF32 on, and turns TF32 on in the libraries besides. The default,
"f32", is plain f32 with TF32 off.

What the model computes (test mode):

1. ResNet-34/8 tokens of both images, Fusion-1 (the target image's tokens
   attend into the source image's).
2. ``num_layers`` x [PointCN, NonLocal]: attention whose logits are
   ``q k^T / sqrt(C)`` times the spatial-consistency matrix
   ``max(0, 1 - (|s_i - s_j| - |t_i - t_j|)^2 / sigma_d^2)``, padded keys
   at -1e9; the message MLP; Fusion-2 with LCPE added to it.
3. The confidence MLP; seeds by score NMS; each seed's k nearest
   neighbours in feature space; spectral matching of the seed's
   neighbourhood (power iteration with the batch-wide early exit);
   weighted Kabsch by Horn's quaternion; inlier counts; the first best
   seed; its labels; post-refinement with the batch-wide stopping rule.

The train branch (``train_forward``): the same encoder with batch norms
on the batch's statistics, the inlier logits and the feature similarity
matrix M, which the training loss reads.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

_MODE = {"products": "f32"}


@contextlib.contextmanager
def products(mode: str):
    """Compute every product in ``mode``: "f32" (TF32 off) or "tf32"."""
    if mode not in ("f32", "tf32"):
        raise ValueError(f"products mode {mode!r}")
    old = (_MODE["products"], torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    _MODE["products"] = mode
    torch.backends.cuda.matmul.allow_tf32 = mode == "tf32"
    torch.backends.cudnn.allow_tf32 = mode == "tf32"
    try:
        yield
    finally:
        (_MODE["products"], torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def round_tf32(x):
    """f32 rounded to the nearest TF32 value (10 mantissa bits, ties to
    even); finite inputs."""
    i = x.float().contiguous().view(torch.int32)
    i = (i + (0x0FFF + ((i >> 13) & 1))) & ~0x1FFF
    return i.view(torch.float32)


def _p(x):
    """A product's operand in the products' mode (the rounding passes the
    gradient through unchanged)."""
    if _MODE["products"] != "tf32":
        return x
    return x + (round_tf32(x.detach()) - x.detach())


def mm(a, b):
    return torch.matmul(_p(a), _p(b))


def linear(W, name, x):
    return F.linear(_p(x), _p(W[name + ".weight"]), W.get(name + ".bias"))


def conv2d(W, name, x, stride=1, padding=0):
    return F.conv2d(_p(x), _p(W[name + ".weight"]), W.get(name + ".bias"),
                    stride=stride, padding=padding)


def depthwise_conv1d(W, name, x):
    """'SAME' depthwise convolution of kernel 3 along the tokens of
    [B, N, C]."""
    w = W[name + ".weight"]
    y = F.conv1d(_p(x.transpose(1, 2)), _p(w), W[name + ".bias"], padding=1,
                 groups=w.shape[0])
    return y.transpose(1, 2)


def batch_norm(W, name, x, eps=1e-5):
    """Eval-mode batch norm over dim 1 (channels) of x."""
    shape = [1, -1] + [1] * (x.dim() - 2)
    mean = W[name + ".running_mean"].reshape(shape)
    var = W[name + ".running_var"].reshape(shape)
    return ((x - mean) / torch.sqrt(var + eps) * W[name + ".weight"].reshape(
        shape) + W[name + ".bias"].reshape(shape))


def token_batch_norm(W, name, x, train=False, eps=1e-5):
    """Batch norm of [..., C] tokens: the running statistics in eval mode,
    the batch's (biased variance) in train mode."""
    if not train:
        flat = x.reshape(-1, x.shape[-1])
        return batch_norm(W, name, flat, eps).reshape(x.shape)
    dims = tuple(range(x.dim() - 1))
    mean = x.mean(dims)
    var = x.var(dims, correction=0)
    return ((x - mean) / torch.sqrt(var + eps) * W[name + ".weight"]
            + W[name + ".bias"])


def batch_norm2d_train(W, name, x, eps=1e-5):
    mean = x.mean((0, 2, 3), keepdim=True)
    var = x.var((0, 2, 3), keepdim=True, correction=0)
    return ((x - mean) / torch.sqrt(var + eps)
            * W[name + ".weight"].reshape(1, -1, 1, 1)
            + W[name + ".bias"].reshape(1, -1, 1, 1))


def layer_norm(W, name, x):
    return F.layer_norm(x, x.shape[-1:], W[name + ".weight"],
                        W[name + ".bias"], 1e-5)


# -- image encoder ----------------------------------------------------------

RESNET_LAYERS = (("layer1", 3, 1), ("layer2", 4, 2))


def image_tokens(W, prefix, image, train=False):
    """ResNet-34 up to layer2 on [B, H, W, 3] -> [B, H/8 * W/8, C] tokens,
    row-major."""
    bn = batch_norm2d_train if train else batch_norm
    x = image.permute(0, 3, 1, 2)
    x = F.relu(bn(W, prefix + "bn1",
                  conv2d(W, prefix + "conv1", x, stride=2, padding=3)))
    x = F.max_pool2d(x, 3, stride=2, padding=1)
    for layer, blocks, stride in RESNET_LAYERS:
        for i in range(blocks):
            p = f"{prefix}{layer}.{i}."
            s = stride if i == 0 else 1
            identity = x
            if p + "downsample.0.weight" in W:
                identity = bn(W, p + "downsample.1",
                              conv2d(W, p + "downsample.0", x, stride=s))
            out = F.relu(bn(W, p + "bn1",
                            conv2d(W, p + "conv1", x, stride=s, padding=1)))
            out = bn(W, p + "bn2", conv2d(W, p + "conv2", out, padding=1))
            x = F.relu(out + identity)
    return x.flatten(2).transpose(1, 2)


def fusion(W, p, data, queries, pe, heads=1):
    """GMF fusion (PerceiverIO cross-attention): ``queries`` [B, Nq, C]
    attend into ``data`` [B, Nk, C]; LCPE on both streams first when
    ``pe``; then a GEGLU feed-forward; both with residuals."""
    x = queries
    if pe:
        x = depthwise_conv1d(W, p + "cpe.proj_q", x) + x
        data = depthwise_conv1d(W, p + "cpe.proj_content", data) + data
    a = p + "cross_attend_blocks.0."
    xn = layer_norm(W, a + "norm", x)
    cn = layer_norm(W, a + "norm_context", data)
    q = linear(W, a + "fn.to_q", xn)
    k, v = linear(W, a + "fn.to_kv", cn).chunk(2, dim=-1)
    B, Nq, inner = q.shape
    d = inner // heads
    q = q.reshape(B, Nq, heads, d).transpose(1, 2)
    k = k.reshape(B, -1, heads, d).transpose(1, 2)
    v = v.reshape(B, -1, heads, d).transpose(1, 2)
    att = torch.softmax(mm(q, k.transpose(-1, -2)) * d ** -0.5, dim=-1)
    out = mm(att, v).transpose(1, 2).reshape(B, Nq, inner)
    x = linear(W, a + "fn.to_out", out) + x
    f = p + "cross_attend_blocks.1."
    h = linear(W, f + "fn.net.0", layer_norm(W, f + "norm", x))
    h, gates = h.chunk(2, dim=-1)
    return linear(W, f + "fn.net.2", h * F.gelu(gates)) + x


# -- point encoder ----------------------------------------------------------

def spatial_compat(src, tgt, sigma_d):
    """[B, N, N] spatial consistency of keypoints [B, N, 3], f32; no
    product is involved."""
    def dist(x):
        d2 = sum((x[:, :, None, c] - x[:, None, :, c]) ** 2 for c in range(3))
        return torch.sqrt(d2)

    sig = torch.tensor(sigma_d, dtype=torch.float32)
    sig_sq = float(sig * sig)
    return torch.clamp(1.0 - (dist(src) - dist(tgt)) ** 2 / sig_sq, min=0.0)


def nonlocal_block(W, p, feat, image_feat, mask, compat, train=False):
    C = feat.shape[-1]
    q = linear(W, p + "projection_q", feat)
    k = linear(W, p + "projection_k", feat)
    v = linear(W, p + "projection_v", feat)
    logits = mm(q, k.transpose(-1, -2)) / math.sqrt(C) * compat
    logits = logits.masked_fill(mask[:, None, :] <= 0, -1e9)
    message = mm(torch.softmax(logits, dim=-1), v)
    m = p + "fc_message."
    h = F.relu(token_batch_norm(W, m + "1", linear(W, m + "0", message),
                                train))
    h = F.relu(token_batch_norm(W, m + "4", linear(W, m + "3", h), train))
    h = linear(W, m + "6", h)
    return h + fusion(W, p + "fusion_layer_2.", image_feat, feat, pe=True)


def encode(W, cfg, corr_pos, src, tgt, p_image, q_image, mask, train=False):
    """The encoder's features [B, N, C] for one block of pairs (f32)."""
    e = "encoder."
    image_feat = fusion(
        W, e + "fusion_layer_1.",
        image_tokens(W, e + "image_encoder.backbone.", p_image, train),
        image_tokens(W, e + "image_encoder.backbone.", q_image, train),
        pe=False)
    compat = spatial_compat(src, tgt, cfg["sigma_d"])
    feat = linear(W, e + "layer0", corr_pos)
    for i in range(cfg["num_layers"]):
        c = f"{e}blocks.PointCN_layer_{i}."
        feat = F.relu(token_batch_norm(W, c + "1", linear(W, c + "0", feat),
                                       train))
        feat = nonlocal_block(W, f"{e}blocks.NonLocal_layer_{i}.", feat,
                              image_feat, mask, compat, train)
    return feat


def encode_blocks(W, cfg, batch, pairs_per_block):
    """``encode`` over a batch of test pairs, ``pairs_per_block`` at a time
    (test mode: pairs are independent), so that the dense [b, N, N]
    matrices fit."""
    B = batch["corr_pos"].shape[0]
    out = []
    for a in range(0, B, pairs_per_block):
        s = slice(a, a + pairs_per_block)
        out.append(encode(W, cfg, batch["corr_pos"][s], batch["src"][s],
                          batch["tgt"][s], batch["p_image"][s],
                          batch["q_image"][s], batch["mask"][s]))
    return torch.cat(out)


def classify(W, feats):
    """Inlier logits [B, N] from the features."""
    h = F.relu(linear(W, "classification.0", feats))
    h = F.relu(linear(W, "classification.2", h))
    return linear(W, "classification.4", h)[..., 0]


# -- seed stage -------------------------------------------------------------

def total_order_topk(x, k):
    """Indices of the k largest of f32 ``x`` (last axis) in a total order:
    +0.0 above -0.0, equal keys to the smaller index."""
    bits = x.float().contiguous().view(torch.int32)
    key = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    return torch.sort(key, dim=-1, descending=True, stable=True).indices[
        ..., :k]


def nms_seeds(src, scores, mask, radius, num_seeds, pairs_per_block=4):
    """Score NMS: a point is a local maximum when no point within
    ``radius`` (padded ones included) scores strictly higher. Seeds: the
    ``num_seeds`` best of ``score * is_local_max``, padded points never."""
    local = []
    for a in range(0, src.shape[0], pairs_per_block):
        s = src[a:a + pairs_per_block]
        sc = scores[a:a + pairs_per_block]
        d2 = sum((s[:, :, None, c] - s[:, None, :, c]) ** 2 for c in range(3))
        suppressed = ((d2 < radius ** 2) & (sc[:, None, :] > sc[:, :, None]))
        local.append((~suppressed.any(-1)).float())
    ranked = scores * torch.cat(local)
    ranked = torch.where(mask > 0, ranked, torch.full_like(ranked, -math.inf))
    return total_order_topk(ranked, num_seeds)


def normalize(feats):
    return feats / torch.sqrt((feats * feats).sum(-1, keepdim=True) + 1e-12)


def seed_knn(normed, seeds, mask, k):
    """The k nearest neighbours in feature space of each seed [B, S, k]:
    the k + 1 largest inner products (ties to the smaller index, padded
    keys last), the first, the seed itself, dropped."""
    C = normed.shape[-1]
    seed_feats = torch.gather(normed, 1, seeds[..., None].expand(-1, -1, C))
    score = mm(seed_feats, normed.transpose(-1, -2))
    score = torch.where(mask[:, None, :] > 0, score,
                        torch.full_like(score, -math.inf))
    order = torch.sort(score, dim=-1, descending=True, stable=True).indices
    return order[..., 1:k + 1]


def gather_rows(x, idx):
    """x [B, N, D], idx [B, S, k] -> [B, S, k, D]."""
    B, S, k = idx.shape
    D = x.shape[-1]
    return torch.gather(x, 1, idx.reshape(B, S * k, 1).expand(-1, -1, D)
                        ).reshape(B, S, k, D)


def power_iteration(M, num_iters):
    """Leading eigenvector of nonnegative M [..., k, k] from the all-ones
    vector; stops once every block of the batch moved by at most 1e-8 +
    1e-5 |v| in the last round."""
    v = torch.ones(M.shape[:-1], dtype=M.dtype, device=M.device)
    v_last = torch.full_like(v, -1e30)
    for _ in range(num_iters):
        if bool(((v - v_last).abs() <= 1e-8 + 1e-5 * v_last.abs()).all()):
            break
        w = mm(M, v[..., None])[..., 0]
        w = w / (torch.sqrt((w * w).sum(-1, keepdim=True) + 1e-24) + 1e-6)
        v, v_last = w, v
    return v


def horn_kabsch(A, B, w):
    """Weighted rigid fit B ~ R A + t by Horn's quaternion method: the
    leading eigenvector of Horn's 4x4 matrix by 7 normalised squarings of
    the matrix shifted by its Gershgorin bound plus one, then two matrix
    vector products. [..., n, 3] x2, [..., n] -> [..., 4, 4]."""
    eps = 1e-6
    wsum = w.sum(-1, keepdim=True)
    cA = (A * w[..., None]).sum(-2) / (wsum + eps)
    cB = (B * w[..., None]).sum(-2) / (wsum + eps)
    Am = A - cA[..., None, :]
    Bm = B - cB[..., None, :]
    H = mm((Am * w[..., None]).transpose(-1, -2), Bm)
    S = [[H[..., i, j] for j in range(3)] for i in range(3)]
    (xx, xy, xz), (yx, yy, yz), (zx, zy, zz) = S
    N = torch.stack([torch.stack(r, -1) for r in (
        [xx + yy + zz, yz - zy, zx - xz, xy - yx],
        [yz - zy, xx - yy - zz, xy + yx, zx + xz],
        [zx - xz, xy + yx, yy - xx - zz, yz + zy],
        [xy - yx, zx + xz, yz + zy, zz - xx - yy])], -2)
    shift = N.abs().sum(-1).amax(-1)
    M = N + (shift[..., None, None] + 1.0) * torch.eye(
        4, dtype=N.dtype, device=N.device)
    for _ in range(7):
        M = mm(M, M)
        M = M / (torch.sqrt((M * M).sum((-2, -1), keepdim=True)) + eps)
    q = torch.ones(N.shape[:-1], dtype=N.dtype, device=N.device)
    for _ in range(2):
        q = mm(M, q[..., None])[..., 0]
        q = q / (torch.sqrt((q * q).sum(-1, keepdim=True)) + eps)
    qw, qx, qy, qz = q.unbind(-1)
    R = torch.stack([torch.stack(r, -1) for r in (
        [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw),
         2 * (qx * qz + qy * qw)],
        [2 * (qx * qy + qz * qw), 1 - 2 * (qx * qx + qz * qz),
         2 * (qy * qz - qx * qw)],
        [2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw),
         1 - 2 * (qx * qx + qy * qy)])], -2)
    t = cB - mm(R, cA[..., None])[..., 0]
    T = torch.zeros(R.shape[:-2] + (4, 4), dtype=R.dtype, device=R.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3] = 1.0
    return T


def apply(T, pts):
    """R p + t for pts [..., N, 3] and T [..., 4, 4]."""
    return mm(pts, T[..., :3, :3].transpose(-1, -2)) + T[..., None, :3, 3]


def feature_matrix(f):
    """Inner products of each neighbourhood's features [..., k, k]."""
    return mm(f, f.transpose(-1, -2))


def seed_transforms(cfg, normed, sigma, src, tgt, knn):
    """Spectral matching of each seed's neighbourhood and its weighted
    Kabsch: [B, S, 4, 4]."""
    B, S, k = knn.shape
    f = gather_rows(normed, knn)
    s = gather_rows(src, knn)
    t = gather_rows(tgt, knn)
    feat_M = feature_matrix(f)
    feat_M = torch.clamp(1.0 - (1.0 - feat_M) / sigma ** 2, min=0.0)
    sig = torch.tensor(cfg["sigma_d"], dtype=torch.float32)
    ds = torch.sqrt(sum((s[..., :, None, c] - s[..., None, :, c]) ** 2
                        for c in range(3)))
    dt = torch.sqrt(sum((t[..., :, None, c] - t[..., None, :, c]) ** 2
                        for c in range(3)))
    spatial = torch.clamp(1.0 - (ds - dt) ** 2 / float(sig * sig), min=0.0)
    M = feat_M * spatial * (1.0 - torch.eye(k, device=normed.device))
    v = power_iteration(M.reshape(B * S, k, k),
                        cfg["num_iterations"]).reshape(B, S, k)
    w = v / (v.sum(-1, keepdim=True) + 1e-6)
    return horn_kabsch(s, t, w)


def seed_residuals_sq(T, src, tgt):
    """|R_s src_n + t_s - tgt_n|^2 [B, S, N], one rounded f32 operation at
    a time in one order: ((R0 x + R1 y) + R2 z) + t - u per coordinate,
    then (px^2 + py^2) + pz^2."""
    s = src[:, None]
    x, y, z = s[..., 0], s[..., 1], s[..., 2]
    out = None
    for r in range(3):
        R = T[:, :, r, :, None]
        p = ((R[:, :, 0] * x + R[:, :, 1] * y) + R[:, :, 2] * z
             + R[:, :, 3]) - tgt[:, None, :, r]
        out = p * p if out is None else out + p * p
    return out


def inlier_counts(T, src, tgt, mask, threshold, seeds_per_block=128):
    """Inliers of each hypothesis T [B, S, 4, 4]: [B, S] int64."""
    thr = torch.tensor(threshold, dtype=torch.float32) ** 2
    out = []
    for a in range(0, T.shape[1], seeds_per_block):
        r2 = seed_residuals_sq(T[:, a:a + seeds_per_block], src, tgt)
        out.append(((r2 < thr) & (mask[:, None, :] > 0)).sum(-1))
    return torch.cat(out, 1)


def labels_of(T, src, tgt, mask, threshold):
    """Labels of one transform a pair [B, 4, 4]: residual under the
    threshold, padded rows 0."""
    d = torch.sqrt(((apply(T, src) - tgt) ** 2).sum(-1))
    return (d < threshold).float() * mask


def refine(cfg, T, src, tgt, mask):
    """Post-refinement: up to 20 weighted refits, weights inlier / (1 +
    (d / tau)^2); the batch stops once no pair's inlier count changed,
    and while any did every pair is refitted."""
    tau = 0.10 if cfg["inlier_threshold"] == 0.10 else 1.2
    prev = torch.zeros(T.shape[0], dtype=torch.int64, device=T.device)
    for _ in range(20):
        d = torch.sqrt(((apply(T, src) - tgt) ** 2).sum(-1))
        inl = (d < tau).float() * mask
        num = inl.sum(-1).long()
        if not bool(((num - prev).abs() >= 1).any()):
            break
        T = horn_kabsch(src, tgt, inl / (1.0 + (d / tau) ** 2))
        prev = num
    return T


def seed_stage(W, cfg, feats, batch):
    """The test-mode seed stage from encoder features [B, N, C]: dict of
    confidence, seeds, seed_trans [B, S, 4, 4], counts [B, S], winner [B],
    labels [B, N] and refined transforms [B, 4, 4]."""
    src, tgt, mask = batch["src"], batch["tgt"], batch["mask"]
    N = src.shape[1]
    confidence = classify(W, feats)
    num_seeds = max(int(N * cfg["ratio"]), 1)
    seeds = nms_seeds(src, confidence, mask, cfg["nms_radius"], num_seeds)
    normed = normalize(feats)
    knn = seed_knn(normed, seeds, mask, min(cfg["k"], N - 1))
    seed_trans = seed_transforms(cfg, normed, W["sigma"], src, tgt, knn)
    out = dict(confidence=confidence, seeds=seeds, seed_trans=seed_trans)
    out.update(select_and_refine(cfg, seed_trans, batch))
    return out


def select_and_refine(cfg, seed_trans, batch, winner=None):
    """Counts of each hypothesis, the first best (or ``winner``), its
    labels, and its refined transform."""
    src, tgt, mask = batch["src"], batch["tgt"], batch["mask"]
    counts = inlier_counts(seed_trans, src, tgt, mask,
                           cfg["inlier_threshold"])
    if winner is None:
        winner = counts.argmax(-1)
    rows = torch.arange(seed_trans.shape[0], device=seed_trans.device)
    best = seed_trans[rows, winner]
    return dict(counts=counts, winner=winner,
                labels=labels_of(best, src, tgt, mask,
                                 cfg["inlier_threshold"]),
                final_trans=refine(cfg, best, src, tgt, mask))


# -- train branch -----------------------------------------------------------

def train_forward(W, cfg, batch):
    """The train branch's outputs that the training loss reads (batch
    norms on the batch's statistics): the inlier logits and the feature
    similarity matrix M. (The branch's seeds and hypotheses feed only the
    transformation loss, whose weight is 0 in the configuration.)"""
    src, tgt, mask = batch["src"], batch["tgt"], batch["mask"]
    N = src.shape[1]
    feats = encode(W, cfg, batch["corr_pos"], src, tgt, batch["p_image"],
                   batch["q_image"], mask, train=True)
    normed = normalize(feats)
    M = mm(normed, normed.transpose(-1, -2))
    M = torch.clamp(1.0 - (1.0 - M) / W["sigma"] ** 2, 0.0, 1.0)
    M = M * (1.0 - torch.eye(N, device=M.device))
    return dict(final_labels=classify(W, feats), M=M)
