"""Loading a PointDSC or OANet model from any checkpoint format, and
the DGR engine's two nets (``load_dgr``).

Counterpart of ``gmf_tpu/utils/model_io.py``, with the reference's
contract that evaluation reads the model's settings from the checkpoint:

- a directory: the port's own checkpoint (``utils/checkpoint.py``), whose
  ``config.json`` holds the settings it was trained with under "model";
- a directory ``gmf_tpu`` wrote (``state.msgpack``): its variables tree,
  converted by ``load_state`` to the port's ``state_dict`` with the
  bridges of ``utils/bridge.py``, for each layout ``gmf_tpu`` writes:
  ``Trainer.save`` (config "model" without "arch"), the ``convert_torch``
  command ("arch" pointdsc or oanet), ``train_dgr``'s snapshots (config
  ``{"dgr", "descriptor"}``) and a bare variables tree (no config). Its
  settings are read as ``gmf_tpu``'s ``load_pointdsc`` reads them
  (``gmf_pointdsc_kwargs``);
- a ``.pkl``/``.pth`` file: a reference torch ``state_dict`` (or a dict
  holding one under "state_dict"), read directly. The port's module names
  are the reference's torch names, so no key is renamed. The one
  difference is a shape: the reference's k=1 ``Conv1d`` weights
  (``encoder.layer0``, ``PointCN_layer_i.0``, ``projection_q/k/v``,
  ``fc_message.0/3/6``, ``classification.0/2/4``) are [out, in, 1] where
  the port's ``Linear`` holds [out, in], and the trailing axis is
  dropped. OANet's names (``models/oanet.py``) are its reference's too,
  with the same k=1 weights. Keys that the port's model does not have (the reference's
  image backbone past ``layer2``, an optimizer's state) are ignored, as
  the JAX converter ignores them; a missing batch-norm
  ``num_batches_tracked`` counter is set to 0, which eval mode never
  reads.
"""

from __future__ import annotations

import inspect
import os
from typing import Any, Dict, Optional, Tuple

import torch

from gmf_tpu_torch.models import PointDSC
from gmf_tpu_torch.models.oanet import OANet
from gmf_tpu_torch.models.registry import MODELS
from gmf_tpu_torch.utils.bridge import (TORCH_ONLY, get_leaf, leaf_rows,
                                        rows_to_state_dict, rows_to_tree)
from gmf_tpu_torch.utils.checkpoint import is_gmf_tree, load_checkpoint
from gmf_tpu_torch.utils.device import resolve_device

# gmf_tpu's PointDSC fields that its load_pointdsc takes from a
# checkpoint's config "model" (all but parent, name, dtype; ring_mesh is
# never recorded), and its defaults where the port's differ
GMF_POINTDSC_FIELDS = (
    "in_dim", "num_layers", "num_channels", "num_iterations", "ratio",
    "inlier_threshold", "sigma_d", "k", "nms_radius", "kabsch_method",
    "fused_attention", "compat_cache", "compat_cache_shards", "knn_topk",
    "hypo_scoring", "seed_solver")
GMF_POINTDSC_DEFAULTS = {"fused_attention": False}


def _state_dict_file(path: str) -> Dict[str, torch.Tensor]:
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return {k: torch.as_tensor(v) for k, v in obj.items()}


def reference_state_dict(model, sd: Dict[str, torch.Tensor]
                         ) -> Dict[str, torch.Tensor]:
    """A reference torch ``state_dict`` as ``model``'s (module
    docstring); raises KeyError on a key the model needs and ``sd``
    lacks."""
    out = {}
    for name, want in model.state_dict().items():
        if name not in sd:
            if name.endswith("num_batches_tracked"):
                out[name] = torch.zeros_like(want)
                continue
            raise KeyError(f"the state_dict has no {name!r}")
        value = sd[name]
        if value.dim() == want.dim() + 1 and value.shape[-1] == 1:
            value = value[..., 0]  # Conv1d k=1 -> Linear
        out[name] = value.to(want.dtype)
    return out


def gmf_pointdsc_kwargs(config: Optional[Dict], **fallback) -> Dict:
    """The port's ``PointDSC`` keywords for the model ``gmf_tpu``'s
    ``load_pointdsc`` builds from a ``gmf_tpu`` checkpoint's config: its
    "model" fields that ``gmf_tpu``'s PointDSC has (``fallback``, the
    loader's keyword settings, where there is no "model"), over
    ``gmf_tpu``'s defaults where they differ from the port's
    (``fused_attention=False``: the dense path). ``dtype`` is never read
    from it, as ``gmf_tpu`` never does: the model is f32 unless the
    caller asks otherwise."""
    model = (config or {}).get("model")
    kw = ({k: v for k, v in model.items() if k in GMF_POINTDSC_FIELDS}
          if model else dict(fallback))
    return {**GMF_POINTDSC_DEFAULTS, **kw}


def _leaves(tree, path=""):
    for key, value in tree.items():
        sub = f"{path}/{key}" if path else str(key)
        if isinstance(value, dict):
            yield from _leaves(value, sub)
        else:
            yield sub


def _as_numpy(tree):
    """The tree with its torch leaves (``bfloat16``, which NumPy lacks) as
    f32 NumPy, for the bridges; every other leaf as it is."""
    if isinstance(tree, dict):
        return {k: _as_numpy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.float().numpy()
    return tree


def _family(arch: str) -> str:
    """The bridge family (``bridge.leaf_rows``) of a net's arch name."""
    if arch.lower() in ("pointdsc", "oanet"):
        return arch.lower()
    if arch == "SparseResUNet2" or arch.startswith("ResUNet"):
        return "resunet"
    if arch in MODELS:
        return "pyramid" if arch.startswith("PyramidNet") else "zoo"
    raise ValueError(f"no converter for a gmf_tpu tree of arch {arch!r}")


def _of(arch, num_layers):
    return f"a {arch}" + (f" of {num_layers} layers" if num_layers else "")


def tree_to_state_dict(tree: Dict, arch: str,
                       num_layers: Optional[int] = None) -> Dict[str, Any]:
    """``gmf_tpu``'s variables tree (``params`` and ``batch_stats``) as
    the port's ``state_dict`` of ``arch``: "pointdsc" and "oanet" (which
    need ``num_layers``), "SparseResUNet2" (the FCGF and 6-D inlier nets)
    or a name of the registry's sparse nets (``models/registry.py``).
    Raises ``ValueError`` naming the tree's paths that the bridge looked
    for and did not find, or that it left unread."""
    family = _family(arch)
    variables = {k: _as_numpy(tree[k]) for k in ("params", "batch_stats")
                 if k in tree}
    rows = leaf_rows(family, num_layers, tree=variables)
    for path, _, _ in rows:
        if path is not None:
            try:
                get_leaf(variables, path)
            except KeyError as e:
                raise ValueError(f"the gmf_tpu tree is not a {arch} one: it "
                                 f"has no {e.args[0]}") from None
    unread = sorted(set(_leaves(variables))
                    - {"/".join(p) for p, _, _ in rows if p is not None})
    if unread:
        raise ValueError(
            f"the gmf_tpu tree holds {len(unread)} arrays that "
            f"{_of(arch, num_layers)} does not have: {', '.join(unread[:8])}"
            + (", ..." if len(unread) > 8 else ""))
    return rows_to_state_dict(rows, variables)


def state_dict_to_tree(sd: Dict[str, torch.Tensor], arch: str,
                       num_layers: Optional[int] = None) -> Dict[str, Any]:
    """The inverse of ``tree_to_state_dict``: the port's ``state_dict`` of
    ``arch`` as ``gmf_tpu``'s ``{"params", "batch_stats"}`` tree of f32
    NumPy arrays, the tree its ``init`` makes. Raises ``ValueError``
    naming every entry of ``sd`` that the tree leaves out, or the first
    that the tree needs and ``sd`` lacks; the torch-only batch-norm
    counters (``bridge.TORCH_ONLY``) are the one exception, neither needed
    nor carried."""
    rows = leaf_rows(_family(arch), num_layers, sd=sd)
    for path, name, _ in rows:
        if path is not None and name not in sd:
            raise ValueError(f"the state_dict is not that of "
                             f"{_of(arch, num_layers)}: it has no {name!r}")
    used = {name for _, name, _ in rows}
    left = sorted(k for k in sd if k not in used
                  and k.rsplit(".", 1)[-1] != TORCH_ONLY)
    if left:
        raise ValueError(
            f"the state_dict holds {len(left)} entries that "
            f"{_of(arch, num_layers)} in gmf_tpu does not have: "
            + ", ".join(left))
    return rows_to_tree(rows, sd)


def _convert(path, tree, arch, num_layers=None):
    """``tree_to_state_dict``, its errors naming the checkpoint."""
    try:
        return tree_to_state_dict(tree, arch, num_layers)
    except ValueError as e:
        raise ValueError(f"checkpoint at {path}: {e}") from None


def _sparse_arch(config) -> str:
    """The arch of a sparse net's checkpoint: the registry's name its
    config records, else ``SparseResUNet2`` (FCGF, the inlier net)."""
    arch = _arch(config)
    if arch is None:
        return "SparseResUNet2"
    if arch not in MODELS or arch in ("PointDSC", "OANet"):
        raise ValueError(f"the checkpoint holds arch={arch!r}, not a "
                         "sparse net's state")
    return arch


def load_state(path: str, arch: str, num_layers: Optional[int] = None
               ) -> Tuple[Dict[str, Any], Optional[Dict]]:
    """(the port's ``state_dict`` on the CPU, config or None) of the
    checkpoint directory ``path``: the port's own as it is, ``gmf_tpu``'s
    converted for ``arch`` (``tree_to_state_dict``; "sparse": the arch
    its config names among the registry's sparse nets, else
    ``SparseResUNet2``). For "pointdsc" and "oanet", ``num_layers``
    defaults to the config's "model" one."""
    state, config = load_checkpoint(path)
    if not is_gmf_tree(state):
        return state, config
    if arch == "sparse":
        arch = _sparse_arch(config)
    if num_layers is None:
        num_layers = ((config or {}).get("model") or {}).get("num_layers")
    return _convert(path, state, arch, num_layers), config


def load_pointdsc(path: str, inlier_threshold: float = 0.10,
                  num_layers: int = 12, num_channels: int = 128,
                  **model_kw):
    """A ``PointDSC`` with the weights at ``path`` (module docstring).

    From a directory the model's settings are the checkpoint's (the
    keyword arguments above serve only a checkpoint without them; a
    ``gmf_tpu`` checkpoint's are read by ``gmf_pointdsc_kwargs``); from a
    torch file they are these. ``model_kw`` goes to ``PointDSC`` on top
    of them: ``device`` (default the card), ``dtype``, or any mode.
    """
    kw = dict(num_layers=num_layers, num_channels=num_channels,
              inlier_threshold=inlier_threshold)
    if os.path.isdir(path):
        state, config = load_checkpoint(path)
        arch = _arch(config)
        if arch not in (None, "pointdsc", "PointDSC"):
            raise ValueError(f"checkpoint at {path} holds arch={arch!r}, "
                             "not a PointDSC state")
        if is_gmf_tree(state):
            kw = gmf_pointdsc_kwargs(config, **kw)
            state = _convert(path, state, "pointdsc", kw["num_layers"])
        elif config and "model" in config:
            valid = inspect.signature(PointDSC).parameters
            kw = {k: v for k, v in config["model"].items() if k in valid}
        model = PointDSC(**{**kw, **model_kw})
        model.load_state_dict(state, strict=True)
        return model
    model = PointDSC(**{**kw, **model_kw})
    sd = reference_state_dict(model, _state_dict_file(path))
    model.load_state_dict(sd, strict=True)
    return model


def _arch(config) -> str:
    config = config or {}
    return config.get("arch") or (config.get("model") or {}).get("arch")


def oanet_config(sd: Dict[str, torch.Tensor], num_layers: int = 6) -> Dict:
    """OANet's settings from a reference ``state_dict``'s shapes: in_dim
    and num_channels from ``l1_1.0``, num_clusters from ``down1.conv.3``
    (``num_layers`` the shapes do not say)."""
    c, d = sd["l1_1.0.weight"].shape[:2]
    return dict(in_dim=int(d), num_layers=num_layers, num_channels=int(c),
                num_clusters=int(sd["down1.conv.3.weight"].shape[0]))


def load_oanet(path: str, num_layers: int = 6, device=None,
               dtype: torch.dtype = torch.float32) -> OANet:
    """An ``OANet`` with the weights at ``path``, on ``device`` (default
    the card), in eval mode (batch norms on their running statistics, as
    ``gmf_tpu``'s OANet applies by default): a checkpoint directory whose
    config says ``arch: oanet`` (the port's or ``gmf_tpu``'s
    ``convert_torch`` command writes one; ``gmf_tpu``'s records only
    ``num_layers``, and the tree's shapes give the rest), or a reference
    torch ``state_dict`` file, whose shapes give the settings
    (``num_layers`` they do not)."""
    dev = resolve_device(device)
    if os.path.isdir(path):
        state, config = load_checkpoint(path)
        if _arch(config) not in ("oanet", "OANet"):
            raise ValueError(f"checkpoint at {path} holds "
                             f"arch={_arch(config)!r}, not an OANet state")
        valid = inspect.signature(OANet).parameters
        kw = {k: v for k, v in config["model"].items() if k in valid}
        if is_gmf_tree(state):
            n = kw.get("num_layers", num_layers)
            state = _convert(path, state, "oanet", n)
            kw = {**oanet_config(state, n), **kw}
        model = OANet(**kw, dtype=dtype)
    else:
        sd = _state_dict_file(path)
        model = OANet(**oanet_config(sd, num_layers), dtype=dtype)
        state = reference_state_dict(model, sd)
    model.load_state_dict(state, strict=True)
    return model.to(dev).eval()


def load_dgr(fcgf_path: str, inlier_path: str
             ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """The state dicts of the FCGF and inlier nets (``sparse/resunet.py``)
    from two checkpoint directories, the port's or ``gmf_tpu``'s
    (``load_state``), on the CPU, for ``DeepGlobalRegistration`` (which
    loads them strictly)."""
    return (load_state(fcgf_path, "sparse")[0],
            load_state(inlier_path, "sparse")[0])
