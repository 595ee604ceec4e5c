"""Random PointDSC+GMF weights from a seed, made on the device.

The benchmark's own list of the published network's tensors (the
reference's torch module names and shapes), filled from one
``torch.Generator`` on the device in one draw: weights normal with a
fan-based scale (LeCun, 1/fan_in, for the image encoder and the fusion
layers; Xavier, 2/(fan_in + fan_out), elsewhere), biases zero, batch
norms the identity (weight 1, bias 0, running mean 0, variance 1). Both
the program and the reference take this dict.
"""

from __future__ import annotations

import math
from collections import OrderedDict

import torch


def _fusion(p, C, pe):
    d = C // 2  # cross_dim_head, one head
    out = OrderedDict()
    if pe:
        for n in ("proj_q", "proj_content"):
            out[f"{p}cpe.{n}.weight"] = ("w", (C, 1, 3))
            out[f"{p}cpe.{n}.bias"] = ("b", (C,))
    a = p + "cross_attend_blocks.0."
    out[a + "fn.to_q.weight"] = ("w", (d, C))
    out[a + "fn.to_kv.weight"] = ("w", (2 * d, C))
    out[a + "fn.to_out.weight"] = ("w", (C, d))
    out[a + "fn.to_out.bias"] = ("b", (C,))
    for n in ("norm", "norm_context"):
        out[f"{a}{n}.weight"] = ("one", (C,))
        out[f"{a}{n}.bias"] = ("b", (C,))
    f = p + "cross_attend_blocks.1."
    out[f + "fn.net.0.weight"] = ("w", (8 * C, C))
    out[f + "fn.net.0.bias"] = ("b", (8 * C,))
    out[f + "fn.net.2.weight"] = ("w", (C, 4 * C))
    out[f + "fn.net.2.bias"] = ("b", (C,))
    out[f + "norm.weight"] = ("one", (C,))
    out[f + "norm.bias"] = ("b", (C,))
    return out


def _bn(p, C):
    return OrderedDict([(p + ".weight", ("one", (C,))), (p + ".bias", ("b", (C,))),
                        (p + ".running_mean", ("b", (C,))),
                        (p + ".running_var", ("one", (C,))),
                        (p + ".num_batches_tracked", ("count", ()))])


def _linear(p, cin, cout):
    return OrderedDict([(p + ".weight", ("w", (cout, cin))),
                        (p + ".bias", ("b", (cout,)))])


def param_shapes(cfg):
    """Ordered {name: (kind, shape)} of the network ``cfg`` describes."""
    C = cfg["num_channels"]
    w = C // 2
    out = OrderedDict(sigma=("one", (1,)))
    r = "encoder.image_encoder.backbone."
    out[r + "conv1.weight"] = ("w", (w, 3, 7, 7))
    out.update(_bn(r + "bn1", w))
    cin = w
    for layer, blocks, width in (("layer1", 3, w), ("layer2", 4, 2 * w)):
        for i in range(blocks):
            p = f"{r}{layer}.{i}."
            out[p + "conv1.weight"] = ("w", (width, cin, 3, 3))
            out.update(_bn(p + "bn1", width))
            out[p + "conv2.weight"] = ("w", (width, width, 3, 3))
            out.update(_bn(p + "bn2", width))
            if cin != width:
                out[p + "downsample.0.weight"] = ("w", (width, cin, 1, 1))
                out.update(_bn(p + "downsample.1", width))
            cin = width
    out.update(_fusion("encoder.fusion_layer_1.", C, pe=False))
    out.update(_linear("encoder.layer0", cfg["in_dim"], C))
    for i in range(cfg["num_layers"]):
        p = f"encoder.blocks.PointCN_layer_{i}."
        out.update(_linear(p + "0", C, C))
        out.update(_bn(p + "1", C))
        p = f"encoder.blocks.NonLocal_layer_{i}."
        for n in ("q", "k", "v"):
            out.update(_linear(f"{p}projection_{n}", C, C))
        m = p + "fc_message."
        out.update(_linear(m + "0", C, C // 2))
        out.update(_bn(m + "1", C // 2))
        out.update(_linear(m + "3", C // 2, C // 2))
        out.update(_bn(m + "4", C // 2))
        out.update(_linear(m + "6", C // 2, C))
        out.update(_fusion(p + "fusion_layer_2.", C, pe=True))
    out.update(_linear("classification.0", C, 32))
    out.update(_linear("classification.2", 32, 32))
    out.update(_linear("classification.4", 32, 1))
    return out


def _std(name, shape):
    fan_in = math.prod(shape[1:])
    fan_out = shape[0] * math.prod(shape[2:])
    if "fusion_layer" in name or "image_encoder" in name:
        return math.sqrt(1.0 / fan_in)
    return math.sqrt(2.0 / (fan_in + fan_out))


def make_weights(cfg, seed: int, device) -> "OrderedDict[str, torch.Tensor]":
    """The network's tensors, f32 on ``device``, drawn from ``seed``."""
    shapes = param_shapes(cfg)
    total = sum(math.prod(s) for k, s in shapes.values() if k == "w")
    g = torch.Generator(device=device).manual_seed(int(seed) ^ 0x5EED)
    draw = torch.randn(total, generator=g, device=device)
    out, at = OrderedDict(), 0
    for name, (kind, shape) in shapes.items():
        if kind == "w":
            n = math.prod(shape)
            out[name] = draw[at:at + n].view(shape) * _std(name, shape)
            at += n
        elif kind == "one":
            out[name] = torch.ones(shape, device=device)
        elif kind == "b":
            out[name] = torch.zeros(shape, device=device)
        else:
            out[name] = torch.zeros(shape, dtype=torch.long, device=device)
    return out
