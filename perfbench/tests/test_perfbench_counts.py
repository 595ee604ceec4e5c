"""Each operation count of ``perfbench/counts.py`` equals what
``torch.utils.flop_counter.FlopCounterMode`` counts on the plain
reference at small shapes (every row valid)."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench import counts
from perfbench.reference import pointdsc as ref
from perfbench.weights import make_weights

CFG = dict(in_dim=6, num_layers=2, num_channels=32, num_iterations=10,
           ratio=0.1, k=8, inlier_threshold=0.1, sigma_d=0.1,
           nms_radius=0.1)
B, N, HW = 2, 60, (24, 32)


def _flops(fn, *args):
    with FlopCounterMode(display=False) as fc:
        fn(*args)
    return fc.get_total_flops()


def _batch():
    g = torch.Generator().manual_seed(0)
    src = torch.rand(B, N, 3, generator=g) * 3
    tgt = torch.rand(B, N, 3, generator=g) * 3
    return dict(corr_pos=torch.cat([src, tgt], -1), src=src, tgt=tgt,
                mask=torch.ones(B, N),
                p_image=torch.rand(B, *HW, 3, generator=g),
                q_image=torch.rand(B, *HW, 3, generator=g))


def test_encoder_count():
    W = make_weights(CFG, 1, "cpu")
    b = _batch()
    got = _flops(ref.encode, W, CFG, b["corr_pos"], b["src"], b["tgt"],
                 b["p_image"], b["q_image"], b["mask"])
    assert got == B * counts.encoder_flops(CFG, N, HW)


def test_trunk_and_fusion_counts():
    W = make_weights(CFG, 1, "cpu")
    img = _batch()["p_image"]
    got = _flops(ref.image_tokens, W, "encoder.image_encoder.backbone.", img)
    assert got == B * counts.resnet_flops(*HW, CFG["num_channels"] // 2)
    T = counts.image_tokens(*HW)
    x = torch.rand(B, T, CFG["num_channels"])
    q = torch.rand(B, N, CFG["num_channels"])
    got = _flops(ref.fusion, W, "encoder.blocks.NonLocal_layer_0."
                 "fusion_layer_2.", x, q, True)
    assert got == B * counts.fusion_flops(N, T, CFG["num_channels"], True)


def test_head_and_seed_counts():
    W = make_weights(CFG, 1, "cpu")
    feats = torch.rand(B, N, CFG["num_channels"])
    assert _flops(ref.classify, W, feats) == B * counts.head_flops(CFG, N)
    S = max(int(N * CFG["ratio"]), 1)
    seeds = torch.arange(S).expand(B, S)
    normed = ref.normalize(feats)
    knn = _flops(ref.seed_knn, normed, seeds, torch.ones(B, N), CFG["k"])
    f = torch.rand(B, S, CFG["k"], CFG["num_channels"])
    fm = _flops(ref.feature_matrix, f)
    assert knn + fm == B * counts.seed_flops(CFG, N, N)


def _conv_backward_flops(grad_out_shape, x_shape, w_shape, _bias, _stride,
                         _padding, _dilation, transposed, _out_padding,
                         groups, output_mask, out_shape):
    """A convolution's backward, groups honoured: each gradient asked for
    is one product of the forward's size (FlopCounterMode's own formula
    counts a depthwise convolution's backward as if it were dense)."""
    import math

    forward = 2 * math.prod(grad_out_shape) * math.prod(w_shape[1:])
    return forward * (int(output_mask[0]) + int(output_mask[1]))


def test_encoder_train_count():
    W = make_weights(CFG, 1, "cpu")
    for k, v in W.items():
        if v.is_floating_point() and not k.endswith(("running_mean",
                                                     "running_var")):
            v.requires_grad_(True)
    b = _batch()

    def step():
        ref.encode(W, CFG, b["corr_pos"], b["src"], b["tgt"], b["p_image"],
                   b["q_image"], b["mask"], train=True).sum().backward()

    aten = torch.ops.aten
    with FlopCounterMode(display=False, custom_mapping={
            aten.convolution_backward: _conv_backward_flops}) as fc:
        step()
    assert fc.get_total_flops() == B * counts.encoder_train_flops(CFG, N, HW)
