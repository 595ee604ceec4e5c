"""Loading a PointDSC model from either checkpoint format, and the DGR
engine's two nets from the port's checkpoints (``load_dgr``).

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
  dropped. Keys that the port's model does not have (the reference's
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
from gmf_tpu_torch.utils.checkpoint import load_checkpoint


def _state_dict_file(path: str) -> Dict[str, torch.Tensor]:
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return {k: torch.as_tensor(v) for k, v in obj.items()}


def _reference_state_dict(model, sd: Dict[str, torch.Tensor]
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
        arch = (config or {}).get("arch") or (
            (config or {}).get("model") or {}).get("arch")
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
    sd = _reference_state_dict(model, _state_dict_file(path))
    model.load_state_dict(sd, strict=True)
    return model


def load_dgr(fcgf_path: str, inlier_path: str
             ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """The state dicts of the FCGF and inlier nets (``sparse/resunet.py``)
    from two port checkpoint directories (``utils/checkpoint.py``), on the
    CPU, for ``DeepGlobalRegistration`` (which loads them strictly)."""
    return load_checkpoint(fcgf_path)[0], load_checkpoint(inlier_path)[0]
