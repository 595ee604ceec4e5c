"""Reference torch checkpoints -> the port's checkpoints.

Counterpart of ``gmf_tpu/utils/convert_torch.py``. The reference ships
torch ``state_dict`` checkpoints (PointDSC's ``model_best.pkl``, OANet's);
the port's modules carry the reference's torch names, so a conversion
only drops the k=1 ``Conv1d`` weights' trailing axis and ignores the keys
the port's model has not (``utils/model_io.py::reference_state_dict``).
``convert_resnet_trunk``, ``convert_image_encoder`` and
``convert_fusion_layer`` convert one part each, as gmf_tpu's do.

    python -m gmf_tpu_torch.utils.convert_torch --input model_best.pkl \\
        --out ckpt_dir [--model pointdsc|oanet] [--num-layers N] \\
        [--checkpoint-format pt|gmf]

writes a port checkpoint directory (``utils/checkpoint.py``) whose
``config.json`` records the source and ``arch`` as gmf_tpu's converter
does: ``load_pointdsc`` reads a PointDSC one and refuses an OANet one,
``load_oanet`` the other way round. ``--checkpoint-format gmf`` writes
the directory gmf_tpu's converter writes, byte for byte.
"""

from __future__ import annotations

import argparse
from typing import Dict

import torch

from gmf_tpu_torch.models.oanet import OANet
from gmf_tpu_torch.nn.fusion import FusionLayer
from gmf_tpu_torch.nn.resnet import ResNet
from gmf_tpu_torch.models.pointdsc import PointDSC
from gmf_tpu_torch.utils.checkpoint import (CHECKPOINT_FORMATS,
                                            save_checkpoint,
                                            save_gmf_checkpoint)
from gmf_tpu_torch.utils.model_io import (oanet_config, reference_state_dict,
                                          state_dict_to_tree)


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A torch checkpoint file as {name: tensor on the CPU}; a dict that
    holds one under "state_dict" (DGR's ``.pth``) gives that one. The
    file is unpickled in full (a DGR checkpoint also holds its config),
    so load only files you trust."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return {k: torch.as_tensor(v) for k, v in obj.items()}


def _view(sd: Dict[str, torch.Tensor], prefix: str
          ) -> Dict[str, torch.Tensor]:
    """The entries of ``sd`` under ``prefix``, the prefix dropped."""
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def convert_resnet_trunk(sd: Dict[str, torch.Tensor], prefix: str = ""
                         ) -> Dict[str, torch.Tensor]:
    """conv1/bn1/layer1/layer2 of a torchvision ResNet-34 under ``prefix``
    as the state_dict of the port's ``ResNet`` (layers (3, 4)); layer3,
    layer4 and fc are left out."""
    part = _view(sd, prefix)
    model = ResNet(base_width=int(part["conv1.weight"].shape[0]))
    return reference_state_dict(model, part)


def convert_image_encoder(sd: Dict[str, torch.Tensor], prefix: str
                          ) -> Dict[str, torch.Tensor]:
    """The reference's image encoder (``<prefix>backbone.<resnet>``) as
    the state_dict of the port's ``ImageEncoder``."""
    return {f"backbone.{k}": v for k, v in convert_resnet_trunk(
        sd, f"{prefix}backbone.").items()}


def convert_fusion_layer(sd: Dict[str, torch.Tensor], prefix: str,
                         pe: bool, depth: int = 0
                         ) -> Dict[str, torch.Tensor]:
    """One reference FusionLayer/PerceiverIO block under ``prefix`` (with
    LCPE when ``pe``, and ``depth`` self-attention layers) as the state_dict
    of the port's ``FusionLayer``, its widths from the shapes."""
    part = _view(sd, prefix)
    cab = "cross_attend_blocks.0."
    latent_dim = int(part[cab + "norm.weight"].shape[0])
    dim = int(part[cab + "norm_context.weight"].shape[0])
    out_dim = int(part[cab + "fn.to_out.weight"].shape[0])
    model = FusionLayer(
        dim=dim, latent_dim=latent_dim, depth=depth, cross_heads=1,
        cross_dim_head=int(part[cab + "fn.to_q.weight"].shape[0]),
        latent_heads=1,
        latent_dim_head=(int(part["layers.0.0.fn.to_q.weight"].shape[0])
                         if depth else 1),
        pe=pe, out_to_context_dim=out_dim == dim)
    return reference_state_dict(model, part)


def convert_oanet(sd: Dict[str, torch.Tensor], num_layers: int = 6
                  ) -> Dict[str, torch.Tensor]:
    """A reference OANet ``state_dict`` (OANet.py:89-156, act_pos 'post')
    as the port's ``OANet`` state_dict, its settings from the shapes."""
    model = OANet(**oanet_config(sd, num_layers))
    return reference_state_dict(model, sd)


def convert_pointdsc(sd: Dict[str, torch.Tensor], num_layers: int = 12
                     ) -> Dict[str, torch.Tensor]:
    """A reference PointDSC ``state_dict`` as the port's, through
    ``load_pointdsc``'s own path (``reference_state_dict``)."""
    model = PointDSC(num_layers=num_layers,
                     num_channels=int(sd["encoder.layer0.weight"].shape[0]),
                     device="cpu")
    return reference_state_dict(model, sd)


def main(argv=None):
    """The command line (module docstring); returns the output path."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--input", required=True,
                    help="torch checkpoint (.pkl/.pth state_dict)")
    ap.add_argument("--out", required=True, help="output checkpoint dir")
    ap.add_argument("--model", choices=["pointdsc", "oanet"],
                    default="pointdsc")
    ap.add_argument("--num-layers", type=int, default=None)
    ap.add_argument("--checkpoint-format", choices=CHECKPOINT_FORMATS,
                    default="pt",
                    help="pt: the port's state.pt; gmf: gmf_tpu's "
                         "state.msgpack and config, as its converter "
                         "writes them")
    args = ap.parse_args(argv)

    sd = load_torch_state_dict(args.input)
    gmf = args.checkpoint_format == "gmf"
    if args.model == "pointdsc":
        n = args.num_layers or 12
        state = convert_pointdsc(sd, num_layers=n)
        cfg = {"converted_from": args.input, "arch": "pointdsc",
               "model": {"num_layers": n, "num_channels": int(
                   state["encoder.layer0.weight"].shape[0])}}
    else:
        n = args.num_layers or 6
        state = convert_oanet(sd, num_layers=n)
        # 'arch' keeps load_pointdsc from reading this as PointDSC's;
        # gmf_tpu records only the depth, its loader reads the shapes
        cfg = {"converted_from": args.input, "arch": "oanet",
               "model": {"arch": "oanet", **({"num_layers": n} if gmf
                                             else oanet_config(sd, n))}}
    if gmf:
        save_gmf_checkpoint(args.out, state_dict_to_tree(
            state, args.model, n), config=cfg)
    else:
        save_checkpoint(args.out, state, config=cfg)
    print(f"converted {args.input} -> {args.out}")
    return args.out


if __name__ == "__main__":
    main()
