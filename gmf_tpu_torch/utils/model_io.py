"""Loading a PointDSC or OANet model from either checkpoint format, and
the DGR engine's two nets from the port's checkpoints (``load_dgr``).

Counterpart of ``gmf_tpu/utils/model_io.py``, with the reference's
contract that evaluation reads the model's settings from the checkpoint:

- a directory: the port's own checkpoint (``utils/checkpoint.py``), whose
  ``config.json`` holds the settings it was trained with under "model";
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
from typing import Dict, Tuple

import torch

from gmf_tpu_torch.models import PointDSC
from gmf_tpu_torch.models.oanet import OANet
from gmf_tpu_torch.utils.checkpoint import load_checkpoint
from gmf_tpu_torch.utils.device import resolve_device


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


def load_pointdsc(path: str, inlier_threshold: float = 0.10,
                  num_layers: int = 12, num_channels: int = 128,
                  **model_kw):
    """A ``PointDSC`` with the weights at ``path`` (module docstring).

    From a directory the model's settings are the checkpoint's (the
    keyword arguments above serve only a checkpoint without them); from a
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
        if config and "model" in config:
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
    the card): a port checkpoint directory whose config says ``arch:
    oanet`` (``utils/convert_torch.py`` writes one), or a reference torch
    ``state_dict`` file, whose shapes give the settings (``num_layers``
    they do not)."""
    dev = resolve_device(device)
    if os.path.isdir(path):
        state, config = load_checkpoint(path)
        if _arch(config) not in ("oanet", "OANet"):
            raise ValueError(f"checkpoint at {path} holds "
                             f"arch={_arch(config)!r}, not an OANet state")
        valid = inspect.signature(OANet).parameters
        kw = {k: v for k, v in config["model"].items() if k in valid}
        model = OANet(**kw, dtype=dtype)
    else:
        sd = _state_dict_file(path)
        model = OANet(**oanet_config(sd, num_layers), dtype=dtype)
        state = reference_state_dict(model, sd)
    model.load_state_dict(state, strict=True)
    return model.to(dev)


def load_dgr(fcgf_path: str, inlier_path: str
             ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """The state dicts of the FCGF and inlier nets (``sparse/resunet.py``)
    from two port checkpoint directories (``utils/checkpoint.py``), on the
    CPU, for ``DeepGlobalRegistration`` (which loads them strictly)."""
    return load_checkpoint(fcgf_path)[0], load_checkpoint(inlier_path)[0]
