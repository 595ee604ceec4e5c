"""Flax PointDSC and sparse-ResUNet variables -> the port's ``state_dict``.

The exact inverse of ``gmf_tpu/utils/convert_torch.py::convert_pointdsc``:
the port's module names are the reference's torch names that converter
reads, so weights cross one to one:

- Dense kernel [in, out]          -> Linear weight [out, in]
- Conv kernel HWIO                -> Conv2d weight OIHW
- depthwise Conv1d kernel [k,1,C] -> Conv1d weight [C, 1, k] (no flip)
- BatchNorm scale/bias, mean/var  -> weight/bias, running_mean/var
- LayerNorm scale/bias            -> weight/bias
- sigma                           -> sigma

Input arrays are NumPy (``jax.device_get`` of the flax variables); the
result loads with ``PointDSC.load_state_dict(..., strict=True)``.

``sparse_resunet_to_state_dict`` does the same for gmf_tpu's
``SparseResUNet2`` (the FCGF and 6-D inlier nets), whose port keeps ME's
names (``gmf_tpu/utils/convert_minkowski.py``):

- SparseConv kernel [K, Cin, Cout] -> ``<conv>.kernel``, rows in the
  same offset order
- MaskedBatchNorm                  -> ``<norm>.bn.*``
- 1x1 Dense kernel [in, out]       -> ``<conv>.kernel`` [in, out], bias
- img_encoder / image_fusion / perceiver_io as PointDSC's encoder parts

``sparse_zoo_to_state_dict`` carries gmf_tpu's ``SimpleSparseUNet`` and
``SparsePyramidNet`` across (kernels as they are, each batch norm
``<name>.bn.*``, PyramidNet's flax ``<name>_bn`` as the port's
``<name>``), and ``oanet_to_state_dict`` gmf_tpu's ``OANet`` onto the
reference's torch names, the inverse of ``convert_oanet``.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, order="C",
                                     copy=True))


def _dense(sd, name, p):
    sd[f"{name}.weight"] = _t(np.asarray(p["kernel"]).T)
    if "bias" in p:
        sd[f"{name}.bias"] = _t(p["bias"])


def _conv2d(sd, name, p):
    sd[f"{name}.weight"] = _t(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))


def _depthwise_conv1d(sd, name, p):
    sd[f"{name}.weight"] = _t(np.asarray(p["kernel"]).transpose(2, 1, 0))
    if "bias" in p:
        sd[f"{name}.bias"] = _t(p["bias"])


def _bn(sd, name, p, s):
    sd[f"{name}.weight"] = _t(p["scale"])
    sd[f"{name}.bias"] = _t(p["bias"])
    sd[f"{name}.running_mean"] = _t(s["mean"])
    sd[f"{name}.running_var"] = _t(s["var"])
    sd[f"{name}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def _ln(sd, name, p):
    sd[f"{name}.weight"] = _t(p["scale"])
    sd[f"{name}.bias"] = _t(p["bias"])


def _resnet_trunk(sd, prefix, p, s):
    _conv2d(sd, f"{prefix}conv1", p["conv1"])
    _bn(sd, f"{prefix}bn1", p["bn1"], s["bn1"])
    for stage in ("layer1", "layer2"):
        i = 0
        while f"{stage}_{i}" in p:
            src, dst = f"{stage}_{i}", f"{prefix}{stage}.{i}"
            i += 1
            bp, bs = p[src], s[src]
            _conv2d(sd, f"{dst}.conv1", bp["conv1"])
            _bn(sd, f"{dst}.bn1", bp["bn1"], bs["bn1"])
            _conv2d(sd, f"{dst}.conv2", bp["conv2"])
            _bn(sd, f"{dst}.bn2", bp["bn2"], bs["bn2"])
            if "downsample_conv" in bp:
                _conv2d(sd, f"{dst}.downsample.0", bp["downsample_conv"])
                _bn(sd, f"{dst}.downsample.1", bp["downsample_bn"],
                    bs["downsample_bn"])


def image_encoder_to_state_dict(p, s, prefix: str = "") -> Dict[str, Any]:
    """ImageEncoder variables (``{"backbone": ...}``) -> state_dict."""
    sd: Dict[str, Any] = {}
    _resnet_trunk(sd, f"{prefix}backbone.", p["backbone"], s["backbone"])
    return sd


def fusion_layer_to_state_dict(p, prefix: str = "") -> Dict[str, Any]:
    """FusionLayer params -> state_dict; the ``depth`` self-attention
    layers (flax ``self_norm_i``, ``self_attn_i``, ``self_ff_norm_i``,
    ``self_ff_i``) become the reference's ``layers.i.{0,1}``."""
    sd: Dict[str, Any] = {}
    if "cpe" in p:
        _depthwise_conv1d(sd, f"{prefix}cpe.proj_q", p["cpe"]["proj_q"])
        _depthwise_conv1d(sd, f"{prefix}cpe.proj_content",
                          p["cpe"]["proj_content"])
    cab = f"{prefix}cross_attend_blocks"
    _ln(sd, f"{cab}.0.norm", p["cross_norm_q"])
    _ln(sd, f"{cab}.0.norm_context", p["cross_norm_ctx"])
    for name in ("to_q", "to_kv", "to_out"):
        _dense(sd, f"{cab}.0.fn.{name}", p["cross_attn"][name])
    _ln(sd, f"{cab}.1.norm", p["cross_ff_norm"])
    _dense(sd, f"{cab}.1.fn.net.0", p["cross_ff"]["proj_in"])
    _dense(sd, f"{cab}.1.fn.net.2", p["cross_ff"]["proj_out"])
    i = 0
    while f"self_attn_{i}" in p:
        lay = f"{prefix}layers.{i}"
        _ln(sd, f"{lay}.0.norm", p[f"self_norm_{i}"])
        for name in ("to_q", "to_kv", "to_out"):
            _dense(sd, f"{lay}.0.fn.{name}", p[f"self_attn_{i}"][name])
        _ln(sd, f"{lay}.1.norm", p[f"self_ff_norm_{i}"])
        _dense(sd, f"{lay}.1.fn.net.0", p[f"self_ff_{i}"]["proj_in"])
        _dense(sd, f"{lay}.1.fn.net.2", p[f"self_ff_{i}"]["proj_out"])
        i += 1
    return sd


def nonlocal_block_to_state_dict(p, s, prefix: str = "") -> Dict[str, Any]:
    """NonLocalBlock params and batch_stats -> state_dict."""
    sd: Dict[str, Any] = {}
    for name in ("projection_q", "projection_k", "projection_v"):
        _dense(sd, f"{prefix}{name}", p[name])
    _dense(sd, f"{prefix}fc_message.0", p["fc_message_0"])
    _bn(sd, f"{prefix}fc_message.1", p["fc_message_bn0"], s["fc_message_bn0"])
    _dense(sd, f"{prefix}fc_message.3", p["fc_message_1"])
    _bn(sd, f"{prefix}fc_message.4", p["fc_message_bn1"], s["fc_message_bn1"])
    _dense(sd, f"{prefix}fc_message.6", p["fc_message_2"])
    sd.update(fusion_layer_to_state_dict(p["fusion_layer_2"],
                                         f"{prefix}fusion_layer_2."))
    return sd


def flax_to_state_dict(variables, num_layers: int) -> Dict[str, Any]:
    """``{"params", "batch_stats"}`` of gmf_tpu's PointDSC -> state_dict
    of gmf_tpu_torch's PointDSC."""
    p, s = variables["params"], variables["batch_stats"]
    ep, es = p["encoder"], s["encoder"]
    sd: Dict[str, Any] = {"sigma": _t(np.asarray(p["sigma"]).reshape(1))}
    _dense(sd, "encoder.layer0", ep["layer0"])
    sd.update(image_encoder_to_state_dict(
        ep["image_encoder"], es["image_encoder"], "encoder.image_encoder."))
    sd.update(fusion_layer_to_state_dict(ep["fusion_layer_1"],
                                         "encoder.fusion_layer_1."))
    for i in range(num_layers):
        pcn = f"encoder.blocks.PointCN_layer_{i}"
        _dense(sd, f"{pcn}.0", ep[f"PointCN_layer_{i}"])
        _bn(sd, f"{pcn}.1", ep[f"PointCN_bn_{i}"], es[f"PointCN_bn_{i}"])
        sd.update(nonlocal_block_to_state_dict(
            ep[f"NonLocal_layer_{i}"], es[f"NonLocal_layer_{i}"],
            f"encoder.blocks.NonLocal_layer_{i}."))
    _dense(sd, "classification.0", p["classification_0"])
    _dense(sd, "classification.2", p["classification_1"])
    _dense(sd, "classification.4", p["classification_2"])
    return sd


def _sparse_bn(sd, name, p, s):
    _bn(sd, f"{name}.bn", p, s)


def sparse_resunet_to_state_dict(variables) -> Dict[str, Any]:
    """``{"params", "batch_stats"}`` of gmf_tpu's ``SparseResUNet2`` (either
    net) -> state_dict of gmf_tpu_torch's ``SparseResUNet2``."""
    p, s = variables["params"], variables["batch_stats"]
    sd: Dict[str, Any] = {}

    def block(name):
        for i in (1, 2):
            sd[f"{name}.conv{i}.kernel"] = _t(p[name][f"conv{i}"]["kernel"])
            _sparse_bn(sd, f"{name}.norm{i}", p[name][f"norm{i}"],
                       s[name][f"norm{i}"])

    for lvl in ("1", "2", "3", "4", "4_tr", "3_tr", "2_tr"):
        sd[f"conv{lvl}.kernel"] = _t(p[f"conv{lvl}"]["kernel"])
        _sparse_bn(sd, f"norm{lvl}", p[f"norm{lvl}"], s[f"norm{lvl}"])
        block(f"block{lvl}")
    sd["conv1_tr.kernel"] = _t(p["conv1_tr"]["kernel"])
    sd["final.kernel"] = _t(p["final"]["kernel"])
    sd["final.bias"] = _t(p["final"]["bias"])
    if "img_encoder" in p:
        sd.update(image_encoder_to_state_dict(
            p["img_encoder"], s["img_encoder"], "img_encoder."))
        sd.update(fusion_layer_to_state_dict(p["image_fusion"],
                                             "image_fusion."))
        sd.update(fusion_layer_to_state_dict(p["perceiver_io"],
                                             "perceiver_io."))
    return sd


def sparse_zoo_to_state_dict(variables) -> Dict[str, Any]:
    """``{"params", "batch_stats"}`` of gmf_tpu's ``SimpleSparseUNet`` or
    ``SparsePyramidNet`` -> the port's state_dict (module docstring)."""
    sd: Dict[str, Any] = {}

    def walk(p, s, path):
        if "scale" in p:
            _sparse_bn(sd, path[:-3] if path.endswith("_bn") else path, p, s)
            return
        if "kernel" in p:
            sd[f"{path}.kernel"] = _t(p["kernel"])
            if "bias" in p:
                sd[f"{path}.bias"] = _t(p["bias"])
            return
        for name, child in p.items():
            walk(child, (s or {}).get(name), f"{path}.{name}" if path
                 else name)

    walk(variables["params"], variables.get("batch_stats", {}), "")
    return sd


def oanet_to_state_dict(variables, num_layers: int) -> Dict[str, Any]:
    """``{"params", "batch_stats"}`` of gmf_tpu's ``OANet`` -> state_dict
    of gmf_tpu_torch's ``OANet`` (the reference's torch names)."""
    p, s = variables["params"], variables["batch_stats"]
    sd: Dict[str, Any] = {}

    def stack(prefix, src, blocks):
        for i in range(blocks):
            _dense(sd, f"{prefix}.{1 + 4 * i}", p[f"{src}_conv_{i}"])
            _bn(sd, f"{prefix}.{3 + 4 * i}", p[f"{src}_bn_{i}"],
                s[f"{src}_bn_{i}"])

    _dense(sd, "l1_1.0", p["layer0"])
    stack("l1_1", "l1_1", num_layers // 2)
    for name in ("down1", "up1"):
        _bn(sd, f"{name}.conv.1", p[name]["bn"], s[name]["bn"])
        _dense(sd, f"{name}.conv.3", p[name]["proj"])
    for i in range(num_layers // 2):
        bp, bs, dst = p[f"oa_{i}"], s[f"oa_{i}"], f"l2.{i}"
        _bn(sd, f"{dst}.conv1.1", bp["bn1"], bs["bn1"])
        _dense(sd, f"{dst}.conv1.3", bp["conv1"])
        _bn(sd, f"{dst}.conv2.0", bp["bn2"], bs["bn2"])
        _dense(sd, f"{dst}.conv2.2", bp["conv2"])
        _bn(sd, f"{dst}.conv3.2", bp["bn3"], bs["bn3"])
        _dense(sd, f"{dst}.conv3.4", bp["conv3"])
    _dense(sd, "l1_2.0", p["l1_2_in"])
    stack("l1_2", "l1_2", num_layers // 2 - 1)
    _dense(sd, "output", p["output"])
    return sd
