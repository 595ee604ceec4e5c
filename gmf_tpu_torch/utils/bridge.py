"""Flax PointDSC, OANet and sparse-net variables <-> the port's ``state_dict``.

Each net's leaves stand in one table that both directions read, so that
they cannot drift apart: a row is (the flax tree path, the port's
``state_dict`` name, the layout between them). The forward direction is
the exact inverse of ``gmf_tpu/utils/convert_torch.py::convert_pointdsc``:
the port's module names are the reference's torch names that converter
reads, so weights cross one to one:

- Dense kernel [in, out]          <-> Linear weight [out, in]
- Conv kernel HWIO                <-> Conv2d weight OIHW
- depthwise Conv1d kernel [k,1,C] <-> Conv1d weight [C, 1, k] (no flip)
- BatchNorm scale/bias, mean/var  <-> weight/bias, running_mean/var
- LayerNorm scale/bias            <-> weight/bias
- sigma                           <-> sigma

Tree arrays are NumPy (``jax.device_get`` of the flax variables, or what
``utils/flax_msgpack.py`` reads); a ``state_dict`` so made loads with
``load_state_dict(..., strict=True)``. The inverse (``state_dict_to_*``)
gives the ``{"params", "batch_stats"}`` tree ``gmf_tpu`` initialises, in
f32 C-order arrays, which ``utils/checkpoint.py::save_gmf_checkpoint``
writes as ``gmf_tpu`` writes it. The torch-only batch-norm counter
``num_batches_tracked`` has no flax leaf: set to 0 one way, dropped the
other.

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
``<name>``); its rows come from whichever side is given, the tree's
modules or the ``state_dict``'s names. ``oanet_to_state_dict`` maps
gmf_tpu's ``OANet`` onto the reference's torch names, the inverse of
``convert_oanet``.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

# the state_dict entries with no flax leaf (torch's batch-norm counter)
TORCH_ONLY = "num_batches_tracked"

# layout -> (tree array to state_dict array, and back)
_LAYOUTS = {
    None: (lambda a: a, lambda a: a),
    "dense": (lambda a: a.T, lambda a: a.T),
    "conv2d": (lambda a: a.transpose(3, 2, 0, 1),
               lambda a: a.transpose(2, 3, 1, 0)),
    "depthwise": (lambda a: a.transpose(2, 1, 0),
                  lambda a: a.transpose(2, 1, 0)),
    "sigma": (lambda a: a.reshape(1), lambda a: a.reshape(1)),
}

Path = Tuple[str, ...]
Row = Tuple[Optional[Path], str, Optional[str]]


class _Table:
    """One net's rows; ``has(path, name)`` tells whether an optional leaf
    or block is there, from the side that exists (the tree's nodes or the
    ``state_dict``'s names)."""

    def __init__(self, has: Callable[[Path, str], bool]):
        self.rows: List[Row] = []
        self.has = has

    def add(self, path: Optional[Path], name: str, layout=None):
        self.rows.append((path, name, layout))

    def opt(self, path: Path, name: str, layout=None):
        if self.has(path, name):
            self.add(path, name, layout)


def _tree_has(tree) -> Callable[[Path, str], bool]:
    def has(path, name):
        node = tree
        for key in path:
            if not isinstance(node, Mapping) or key not in node:
                return False
            node = node[key]
        return True
    return has


def _sd_has(sd) -> Callable[[Path, str], bool]:
    names = set()
    for key in sd:
        parts = key.split(".")
        names.update(".".join(parts[:i]) for i in range(1, len(parts) + 1))
    return lambda path, name: name in names


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, order="C",
                                     copy=True))


def get_leaf(tree, path: Path):
    """The leaf of ``tree`` at ``path``; KeyError naming the path."""
    node = tree
    for i, key in enumerate(path):
        if not isinstance(node, Mapping) or key not in node:
            raise KeyError("/".join(path[:i + 1]))
        node = node[key]
    return node


def rows_to_state_dict(rows: List[Row], tree) -> Dict[str, Any]:
    """The ``state_dict`` the rows read from ``tree``."""
    sd: Dict[str, Any] = {}
    for path, name, layout in rows:
        if path is None:
            sd[name] = torch.tensor(0, dtype=torch.long)
        else:
            sd[name] = _t(_LAYOUTS[layout][0](np.asarray(get_leaf(tree,
                                                                   path))))
    return sd


def rows_to_tree(rows: List[Row], sd) -> Dict[str, Any]:
    """The ``{"params", "batch_stats"}`` tree the rows read from ``sd``:
    f32 C-order NumPy arrays on the host."""
    tree: Dict[str, Any] = {}
    for path, name, layout in rows:
        if path is None:
            continue
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        value = torch.as_tensor(sd[name]).detach().to("cpu", torch.float32)
        node[path[-1]] = np.array(_LAYOUTS[layout][1](value.numpy()),
                                  dtype=np.float32, order="C")
    return tree


# -- the rows of each part ----------------------------------------------------

def _dense_rows(t, name, P):
    t.add(P + ("kernel",), f"{name}.weight", "dense")
    t.opt(P + ("bias",), f"{name}.bias")


def _conv2d_rows(t, name, P):
    t.add(P + ("kernel",), f"{name}.weight", "conv2d")


def _depthwise_conv1d_rows(t, name, P):
    t.add(P + ("kernel",), f"{name}.weight", "depthwise")
    t.opt(P + ("bias",), f"{name}.bias")


def _bn_rows(t, name, P, S):
    t.add(P + ("scale",), f"{name}.weight")
    t.add(P + ("bias",), f"{name}.bias")
    t.add(S + ("mean",), f"{name}.running_mean")
    t.add(S + ("var",), f"{name}.running_var")
    t.add(None, f"{name}.{TORCH_ONLY}")


def _ln_rows(t, name, P):
    t.add(P + ("scale",), f"{name}.weight")
    t.add(P + ("bias",), f"{name}.bias")


def _resnet_trunk_rows(t, prefix, P, S):
    _conv2d_rows(t, f"{prefix}conv1", P + ("conv1",))
    _bn_rows(t, f"{prefix}bn1", P + ("bn1",), S + ("bn1",))
    for stage in ("layer1", "layer2"):
        i = 0
        while t.has(P + (f"{stage}_{i}",), f"{prefix}{stage}.{i}"):
            dst = f"{prefix}{stage}.{i}"
            bp, bs = P + (f"{stage}_{i}",), S + (f"{stage}_{i}",)
            i += 1
            _conv2d_rows(t, f"{dst}.conv1", bp + ("conv1",))
            _bn_rows(t, f"{dst}.bn1", bp + ("bn1",), bs + ("bn1",))
            _conv2d_rows(t, f"{dst}.conv2", bp + ("conv2",))
            _bn_rows(t, f"{dst}.bn2", bp + ("bn2",), bs + ("bn2",))
            if t.has(bp + ("downsample_conv",), f"{dst}.downsample"):
                _conv2d_rows(t, f"{dst}.downsample.0",
                             bp + ("downsample_conv",))
                _bn_rows(t, f"{dst}.downsample.1", bp + ("downsample_bn",),
                         bs + ("downsample_bn",))


def _image_encoder_rows(t, prefix, P, S):
    _resnet_trunk_rows(t, f"{prefix}backbone.", P + ("backbone",),
                       S + ("backbone",))


def _fusion_layer_rows(t, prefix, P):
    """A FusionLayer; its ``depth`` self-attention layers (flax
    ``self_norm_i``, ``self_attn_i``, ``self_ff_norm_i``, ``self_ff_i``)
    are the reference's ``layers.i.{0,1}``."""
    if t.has(P + ("cpe",), f"{prefix}cpe"):
        _depthwise_conv1d_rows(t, f"{prefix}cpe.proj_q", P + ("cpe", "proj_q"))
        _depthwise_conv1d_rows(t, f"{prefix}cpe.proj_content",
                               P + ("cpe", "proj_content"))
    cab = f"{prefix}cross_attend_blocks"
    _ln_rows(t, f"{cab}.0.norm", P + ("cross_norm_q",))
    _ln_rows(t, f"{cab}.0.norm_context", P + ("cross_norm_ctx",))
    for name in ("to_q", "to_kv", "to_out"):
        _dense_rows(t, f"{cab}.0.fn.{name}", P + ("cross_attn", name))
    _ln_rows(t, f"{cab}.1.norm", P + ("cross_ff_norm",))
    _dense_rows(t, f"{cab}.1.fn.net.0", P + ("cross_ff", "proj_in"))
    _dense_rows(t, f"{cab}.1.fn.net.2", P + ("cross_ff", "proj_out"))
    i = 0
    while t.has(P + (f"self_attn_{i}",), f"{prefix}layers.{i}"):
        lay = f"{prefix}layers.{i}"
        _ln_rows(t, f"{lay}.0.norm", P + (f"self_norm_{i}",))
        for name in ("to_q", "to_kv", "to_out"):
            _dense_rows(t, f"{lay}.0.fn.{name}", P + (f"self_attn_{i}", name))
        _ln_rows(t, f"{lay}.1.norm", P + (f"self_ff_norm_{i}",))
        _dense_rows(t, f"{lay}.1.fn.net.0", P + (f"self_ff_{i}", "proj_in"))
        _dense_rows(t, f"{lay}.1.fn.net.2", P + (f"self_ff_{i}", "proj_out"))
        i += 1


def _nonlocal_block_rows(t, prefix, P, S):
    for name in ("projection_q", "projection_k", "projection_v"):
        _dense_rows(t, f"{prefix}{name}", P + (name,))
    _dense_rows(t, f"{prefix}fc_message.0", P + ("fc_message_0",))
    _bn_rows(t, f"{prefix}fc_message.1", P + ("fc_message_bn0",),
             S + ("fc_message_bn0",))
    _dense_rows(t, f"{prefix}fc_message.3", P + ("fc_message_1",))
    _bn_rows(t, f"{prefix}fc_message.4", P + ("fc_message_bn1",),
             S + ("fc_message_bn1",))
    _dense_rows(t, f"{prefix}fc_message.6", P + ("fc_message_2",))
    _fusion_layer_rows(t, f"{prefix}fusion_layer_2.", P + ("fusion_layer_2",))


_P, _S = ("params",), ("batch_stats",)


def _pointdsc_rows(t, num_layers: int):
    E, ES = _P + ("encoder",), _S + ("encoder",)
    t.add(_P + ("sigma",), "sigma", "sigma")
    _dense_rows(t, "encoder.layer0", E + ("layer0",))
    _image_encoder_rows(t, "encoder.image_encoder.", E + ("image_encoder",),
                        ES + ("image_encoder",))
    _fusion_layer_rows(t, "encoder.fusion_layer_1.", E + ("fusion_layer_1",))
    for i in range(num_layers):
        pcn = f"encoder.blocks.PointCN_layer_{i}"
        _dense_rows(t, f"{pcn}.0", E + (f"PointCN_layer_{i}",))
        _bn_rows(t, f"{pcn}.1", E + (f"PointCN_bn_{i}",),
                 ES + (f"PointCN_bn_{i}",))
        _nonlocal_block_rows(t, f"encoder.blocks.NonLocal_layer_{i}.",
                             E + (f"NonLocal_layer_{i}",),
                             ES + (f"NonLocal_layer_{i}",))
    _dense_rows(t, "classification.0", _P + ("classification_0",))
    _dense_rows(t, "classification.2", _P + ("classification_1",))
    _dense_rows(t, "classification.4", _P + ("classification_2",))


def _sparse_resunet_rows(t):
    def bn(name, flax):
        _bn_rows(t, f"{name}.bn", _P + flax, _S + flax)

    def block(name):
        for i in (1, 2):
            t.add(_P + (name, f"conv{i}", "kernel"), f"{name}.conv{i}.kernel")
            bn(f"{name}.norm{i}", (name, f"norm{i}"))

    for lvl in ("1", "2", "3", "4", "4_tr", "3_tr", "2_tr"):
        t.add(_P + (f"conv{lvl}", "kernel"), f"conv{lvl}.kernel")
        bn(f"norm{lvl}", (f"norm{lvl}",))
        block(f"block{lvl}")
    t.add(_P + ("conv1_tr", "kernel"), "conv1_tr.kernel")
    t.add(_P + ("final", "kernel"), "final.kernel")
    t.add(_P + ("final", "bias"), "final.bias")
    if t.has(_P + ("img_encoder",), "img_encoder"):
        _image_encoder_rows(t, "img_encoder.", _P + ("img_encoder",),
                            _S + ("img_encoder",))
        _fusion_layer_rows(t, "image_fusion.", _P + ("image_fusion",))
        _fusion_layer_rows(t, "perceiver_io.", _P + ("perceiver_io",))


def _oanet_rows(t, num_layers: int):
    def stack(prefix, src, blocks):
        for i in range(blocks):
            _dense_rows(t, f"{prefix}.{1 + 4 * i}", _P + (f"{src}_conv_{i}",))
            _bn_rows(t, f"{prefix}.{3 + 4 * i}", _P + (f"{src}_bn_{i}",),
                     _S + (f"{src}_bn_{i}",))

    _dense_rows(t, "l1_1.0", _P + ("layer0",))
    stack("l1_1", "l1_1", num_layers // 2)
    for name in ("down1", "up1"):
        _bn_rows(t, f"{name}.conv.1", _P + (name, "bn"), _S + (name, "bn"))
        _dense_rows(t, f"{name}.conv.3", _P + (name, "proj"))
    for i in range(num_layers // 2):
        bp, bs, dst = _P + (f"oa_{i}",), _S + (f"oa_{i}",), f"l2.{i}"
        _bn_rows(t, f"{dst}.conv1.1", bp + ("bn1",), bs + ("bn1",))
        _dense_rows(t, f"{dst}.conv1.3", bp + ("conv1",))
        _bn_rows(t, f"{dst}.conv2.0", bp + ("bn2",), bs + ("bn2",))
        _dense_rows(t, f"{dst}.conv2.2", bp + ("conv2",))
        _bn_rows(t, f"{dst}.conv3.2", bp + ("bn3",), bs + ("bn3",))
        _dense_rows(t, f"{dst}.conv3.4", bp + ("conv3",))
    _dense_rows(t, "l1_2.0", _P + ("l1_2_in",))
    stack("l1_2", "l1_2", num_layers // 2 - 1)
    _dense_rows(t, "output", _P + ("output",))


def _zoo_from_tree(t, tree):
    """A SimpleSparseUNet's or SparsePyramidNet's rows from its tree's
    modules: a batch norm where a module has a scale, a convolution where
    it has a kernel (and its bias where it has one)."""
    def walk(node, path):
        name = ".".join(path)
        if "scale" in node:
            bn = name[:-3] if name.endswith("_bn") else name
            _bn_rows(t, f"{bn}.bn", _P + path, _S + path)
        elif "kernel" in node:
            t.add(_P + path + ("kernel",), f"{name}.kernel")
            t.opt(_P + path + ("bias",), f"{name}.bias")
        else:
            for key, child in node.items():
                walk(child, path + (key,))

    walk(tree["params"], ())


def _zoo_from_state_dict(t, sd, pyramid: bool):
    """The same rows from the ``state_dict``'s names: PyramidNet's
    top-level norms are flax's ``<name>_bn``, every other's its own."""
    for key in sd:
        if key.endswith(".bn.weight"):
            base = key[:-len(".bn.weight")]
            flax = tuple(base.split("."))
            if pyramid and len(flax) == 1:
                flax = (f"{base}_bn",)
            _bn_rows(t, f"{base}.bn", _P + flax, _S + flax)
        elif key.endswith(".kernel"):
            base = key[:-len(".kernel")]
            path = _P + tuple(base.split("."))
            t.add(path + ("kernel",), key)
            t.opt(path + ("bias",), f"{base}.bias")


def leaf_rows(family: str, num_layers: Optional[int] = None, tree=None,
              sd=None) -> List[Row]:
    """The rows of a net of ``family`` ("pointdsc", "oanet", "resunet",
    "zoo", "pyramid"), read off ``tree`` (a flax variables tree) or ``sd``
    (a ``state_dict``) for its optional parts; "pointdsc" and "oanet"
    need ``num_layers``."""
    if family in ("pointdsc", "oanet") and num_layers is None:
        raise ValueError(f"a {family} table needs num_layers")
    t = _Table(_tree_has(tree) if sd is None else _sd_has(sd))
    if family == "pointdsc":
        _pointdsc_rows(t, num_layers)
    elif family == "oanet":
        _oanet_rows(t, num_layers)
    elif family == "resunet":
        _sparse_resunet_rows(t)
    elif sd is None:
        _zoo_from_tree(t, tree)
    else:
        _zoo_from_state_dict(t, sd, family == "pyramid")
    return t.rows


def _part(build, p, s=None, prefix="") -> Dict[str, Any]:
    """A part's state_dict from its own params and batch_stats."""
    tree = {"params": p, "batch_stats": s or {}}
    t = _Table(_tree_has(tree))
    build(t, prefix, _P, _S)
    return rows_to_state_dict(t.rows, tree)


# one part's entries written into ``sd`` from its own params (and
# batch_stats)
def _dense(sd, name, p):
    sd.update(_part(lambda t, n, P, S: _dense_rows(t, n, P), p, prefix=name))


def _depthwise_conv1d(sd, name, p):
    sd.update(_part(lambda t, n, P, S: _depthwise_conv1d_rows(t, n, P), p,
              prefix=name))


def _resnet_trunk(sd, prefix, p, s):
    sd.update(_part(_resnet_trunk_rows, p, s, prefix))


def image_encoder_to_state_dict(p, s, prefix: str = "") -> Dict[str, Any]:
    """ImageEncoder variables (``{"backbone": ...}``) -> state_dict."""
    return _part(_image_encoder_rows, p, s, prefix)


def fusion_layer_to_state_dict(p, prefix: str = "") -> Dict[str, Any]:
    """FusionLayer params -> state_dict."""
    return _part(lambda t, pre, P, S: _fusion_layer_rows(t, pre, P), p,
                 prefix=prefix)


def nonlocal_block_to_state_dict(p, s, prefix: str = "") -> Dict[str, Any]:
    """NonLocalBlock params and batch_stats -> state_dict."""
    return _part(_nonlocal_block_rows, p, s, prefix)


def _to_state_dict(family, variables, num_layers=None):
    return rows_to_state_dict(
        leaf_rows(family, num_layers, tree=variables), variables)


def flax_to_state_dict(variables, num_layers: int) -> Dict[str, Any]:
    """``{"params", "batch_stats"}`` of gmf_tpu's PointDSC -> state_dict
    of gmf_tpu_torch's PointDSC."""
    return _to_state_dict("pointdsc", variables, num_layers)


def sparse_resunet_to_state_dict(variables) -> Dict[str, Any]:
    """``{"params", "batch_stats"}`` of gmf_tpu's ``SparseResUNet2`` (either
    net) -> state_dict of gmf_tpu_torch's ``SparseResUNet2``."""
    return _to_state_dict("resunet", variables)


def sparse_zoo_to_state_dict(variables) -> Dict[str, Any]:
    """``{"params", "batch_stats"}`` of gmf_tpu's ``SimpleSparseUNet`` or
    ``SparsePyramidNet`` -> the port's state_dict (module docstring)."""
    return _to_state_dict("zoo", {"batch_stats": {}, **variables})


def oanet_to_state_dict(variables, num_layers: int) -> Dict[str, Any]:
    """``{"params", "batch_stats"}`` of gmf_tpu's ``OANet`` -> state_dict
    of gmf_tpu_torch's ``OANet`` (the reference's torch names)."""
    return _to_state_dict("oanet", variables, num_layers)
