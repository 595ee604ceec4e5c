"""Reference torch checkpoints -> the port's checkpoints.

Counterpart of ``gmf_tpu/utils/convert_torch.py``. The reference ships
torch ``state_dict`` checkpoints (PointDSC's ``model_best.pkl``, OANet's);
the port's modules carry the reference's torch names, so a conversion
only drops the k=1 ``Conv1d`` weights' trailing axis and ignores the keys
the port's model has not (``utils/model_io.py::reference_state_dict``).

    python -m gmf_tpu_torch.utils.convert_torch --input model_best.pkl \\
        --out ckpt_dir [--model pointdsc|oanet] [--num-layers N]

writes a port checkpoint directory (``utils/checkpoint.py``) whose
``config.json`` records the source and ``arch`` as gmf_tpu's converter
does: ``load_pointdsc`` reads a PointDSC one and refuses an OANet one,
``load_oanet`` the other way round.
"""

from __future__ import annotations

import argparse
from typing import Dict

import torch

from gmf_tpu_torch.models.oanet import OANet
from gmf_tpu_torch.models.pointdsc import PointDSC
from gmf_tpu_torch.utils.checkpoint import save_checkpoint
from gmf_tpu_torch.utils.model_io import oanet_config, reference_state_dict


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A torch checkpoint file as {name: tensor on the CPU}; a dict that
    holds one under "state_dict" (DGR's ``.pth``) gives that one. The
    file is unpickled in full (a DGR checkpoint also holds its config),
    so load only files you trust."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return {k: torch.as_tensor(v) for k, v in obj.items()}


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
    args = ap.parse_args(argv)

    sd = load_torch_state_dict(args.input)
    if args.model == "pointdsc":
        n = args.num_layers or 12
        state = convert_pointdsc(sd, num_layers=n)
        cfg = {"converted_from": args.input, "arch": "pointdsc",
               "model": {"num_layers": n, "num_channels": int(
                   state["encoder.layer0.weight"].shape[0])}}
    else:
        n = args.num_layers or 6
        state = convert_oanet(sd, num_layers=n)
        # 'arch' keeps load_pointdsc from reading this as PointDSC's
        cfg = {"converted_from": args.input, "arch": "oanet",
               "model": {"arch": "oanet", **oanet_config(sd, n)}}
    save_checkpoint(args.out, state, config=cfg)
    print(f"converted {args.input} -> {args.out}")
    return args.out


if __name__ == "__main__":
    main()
