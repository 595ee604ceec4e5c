"""The algorithm's work, counted from a cell's shapes and valid rows, and
the card's peaks that the per-layer metrics divide by.

Products are counted as 2 x multiply-adds of every matrix product and
convolution the published model computes, each input and output byte
once. What an implementation does besides (a compat cache, a split of f32
into bf16 terms, padded rows, a fused kernel) does not change a count.
``perfbench/tests/test_perfbench_counts.py`` holds each count to
``torch.utils.flop_counter.FlopCounterMode`` on the plain reference.

Peaks: one NVIDIA H100 SXM, dense rates, 700 W: every product is rated at
989 TFLOP/s, the tensor cores' rate for 16-bit operands, the fastest at
which they take operands of 16 bits or more, so that no way of computing
the f32 products can read above 100%; memory at 3.35 TB/s.
"""

from __future__ import annotations

import math

from perfbench.weights import param_shapes

PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def _conv_out(x, k, s, p):
    return (x + 2 * p - k) // s + 1


def resnet_flops(H, W, w):
    """ResNet-34 to layer2, base width ``w``, on one H x W RGB image."""
    h, v = _conv_out(H, 7, 2, 3), _conv_out(W, 7, 2, 3)
    f = 2 * h * v * w * 3 * 49
    h, v = _conv_out(h, 3, 2, 1), _conv_out(v, 3, 2, 1)
    f += 3 * 2 * (2 * h * v * w * w * 9)  # layer1: 3 blocks of 2 convs
    h, v = _conv_out(h, 3, 2, 1), _conv_out(v, 3, 2, 1)
    c = 2 * w
    f += 2 * h * v * c * w * 9 + 2 * h * v * c * c * 9 + 2 * h * v * c * w
    f += 3 * 2 * (2 * h * v * c * c * 9)  # layer2 blocks 1-3
    return f


def image_tokens(H, W):
    h = _conv_out(_conv_out(_conv_out(H, 7, 2, 3), 3, 2, 1), 3, 2, 1)
    v = _conv_out(_conv_out(_conv_out(W, 7, 2, 3), 3, 2, 1), 3, 2, 1)
    return h * v


def fusion_flops(nq, nk, C, pe):
    """One GMF fusion layer: nq queries into nk context tokens, width C,
    one head of C / 2, GEGLU feed-forward of 4C, LCPE when ``pe``."""
    d = C // 2
    f = (2 * nq * C * d + 2 * nk * C * 2 * d + 2 * 2 * nq * nk * d
         + 2 * nq * d * C + 2 * nq * C * 8 * C + 2 * nq * 4 * C * C)
    if pe:
        f += 2 * 3 * nq * C + 2 * 3 * nk * C
    return f


def encoder_flops(cfg, n, image_hw):
    """Products of the encoder for one pair of ``n`` valid rows: both
    images' trunks, Fusion-1, layer0, and per layer PointCN, the q/k/v
    projections, attention (4 n^2 C: q k^T and the weights times v), the
    message MLP and Fusion-2 with LCPE."""
    C = cfg["num_channels"]
    H, W = image_hw
    T = image_tokens(H, W)
    f = 2 * resnet_flops(H, W, C // 2) + fusion_flops(T, T, C, pe=False)
    f += 2 * n * cfg["in_dim"] * C
    layer = (2 * n * C * C + 3 * 2 * n * C * C + 4 * n * n * C
             + 2 * n * (C * C // 2 + (C // 2) ** 2 + C // 2 * C)
             + fusion_flops(n, T, C, pe=True))
    return f + cfg["num_layers"] * layer


def encoder_param_count(cfg):
    """Entries of the encoder's tensors (running statistics included)."""
    return sum(math.prod(shape) for name, (kind, shape)
               in param_shapes(cfg).items()
               if name.startswith("encoder.") and kind != "count")


def encoder_bytes(cfg, valid, image_hw):
    """Bytes the encoder must read and write once for a batch of pairs of
    ``valid`` rows each (f32): per pair corr_pos, both keypoint sets, the
    mask, both images and the features out; the weights once."""
    H, W = image_hw
    rows = sum(valid)
    return 4 * (rows * (6 + 3 + 3 + 1 + cfg["num_channels"])
                + len(valid) * 2 * H * W * 3 + encoder_param_count(cfg))


def encoder_least_s(cfg, valid, image_hw):
    """The least time of the encoder on a batch of pairs of ``valid``
    rows: the larger of its products at the peak rate and its bytes at
    the peak bandwidth."""
    flops = sum(encoder_flops(cfg, n, image_hw) for n in valid)
    return max(flops / PEAK_FLOPS,
               encoder_bytes(cfg, valid, image_hw) / PEAK_BYTES)


def head_flops(cfg, n):
    """The confidence MLP on ``n`` rows."""
    C = cfg["num_channels"]
    return 2 * n * (C * 32 + 32 * 32 + 32)


def seed_flops(cfg, n, bucket):
    """The seed stage's fixed products: each seed's inner products with
    the pair's valid rows (kNN) and its neighbourhood's feature matrix."""
    C, k = cfg["num_channels"], cfg["k"]
    S = max(int(bucket * cfg["ratio"]), 1)
    return 2 * S * n * C + 2 * S * k * k * C


def model_flops(cfg, n, bucket, image_hw):
    """A test-mode forward's counted products for one pair."""
    return (encoder_flops(cfg, n, image_hw) + head_flops(cfg, n)
            + seed_flops(cfg, n, bucket))


def first_layer_flops(cfg, n, image_hw):
    """Products whose input needs no gradient in training: each image's
    first convolution and layer0 on corr_pos."""
    H, W = image_hw
    h, v = _conv_out(H, 7, 2, 3), _conv_out(W, 7, 2, 3)
    return 2 * (2 * h * v * cfg["num_channels"] // 2 * 3 * 49) \
        + 2 * n * cfg["in_dim"] * cfg["num_channels"]


def encoder_train_flops(cfg, n, image_hw):
    """The encoder's forward and backward for one pair in training: each
    product's backward is two products of its size (both operands'
    gradients), one where the input needs none (``first_layer_flops``)."""
    return 3 * encoder_flops(cfg, n, image_hw) \
        - first_layer_flops(cfg, n, image_hw)


def train_flops(cfg, n, image_hw):
    """A training step's counted products for one pair of ``n`` rows:
    the encoder's forward and backward, the confidence MLP's, the feature
    matrix M's (2 n^2 C forward) and the seed neighbourhoods' (forward
    and backward), the seeds' kNN scores (forward only: detached)."""
    C = cfg["num_channels"]
    S = max(int(n * cfg["ratio"]), 1)
    knn = 2 * S * n * C
    return (encoder_train_flops(cfg, n, image_hw)
            + 3 * (head_flops(cfg, n) + 2 * n * n * C
                   + seed_flops(cfg, n, n) - knn) + knn)
