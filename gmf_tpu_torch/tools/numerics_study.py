"""Numerical-correctness side studies (reference parity P22).

Counterpart of ``gmf_tpu/tools/numerics_study.py`` (GMF_PointDSC/misc/
eigen.py, power iteration against a full eigendecomposition, and
misc/svd_speed.py, the study behind the reference's CPU-SVD workaround).
On the port's device (the card unless ``--cpu``), f32 with TF32 off:

1. power iteration (``geometry/spectral.leading_eigenvector_fixed``, 10
   rounds) against ``torch.linalg.eigh`` for seed-block leading
   eigenvectors: their alignment and time;
2. the Horn-quaternion Kabsch (``kabsch_quat``) against the SVD one
   (``kabsch_svd``): their rotations' distance and time.

The library calls (``eigh``, ``svd``) are the study's subject here, not a
kernel of the port. Times on the card come from CUDA events over 10 calls
after a warm-up; under ``--cpu`` they are host-clock times of PyTorch's
CPU kernels and say nothing of the card.

Usage: python -m gmf_tpu_torch.tools.numerics_study [--cpu]
"""

from __future__ import annotations

import argparse
import json
from typing import Dict

import numpy as np
import torch

from gmf_tpu_torch.geometry.kabsch import kabsch_quat, kabsch_svd
from gmf_tpu_torch.geometry.spectral import leading_eigenvector_fixed
from gmf_tpu_torch.utils.device import resolve_device, time_ms


def main(argv=None) -> Dict[str, object]:
    """Prints the two studies and returns their numbers."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the card)")
    ap.add_argument("--batch", type=int, default=800)
    ap.add_argument("--k", type=int, default=40)
    args = ap.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else None)
    clock = "CUDA events" if dev.type == "cuda" else "host clock, CPU"
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "cpu")

    rng = np.random.RandomState(0)
    B, K = args.batch, args.k
    out: Dict[str, object] = {"device": where, "clock": clock, "batch": B,
                              "k": K}

    # --- study 1: leading eigenvector --------------------------------
    X = rng.rand(B, K, K).astype(np.float32)
    M = torch.as_tensor(X @ X.transpose(0, 2, 1), device=dev)

    def f_pow():
        return leading_eigenvector_fixed(M, num_iters=10)

    def f_eigh():
        return torch.linalg.eigh(M)[1][..., -1]

    for name, f, key in (("power(10)", f_pow, "power_ms"),
                         ("eigh", f_eigh, "eigh_ms")):
        out[key] = time_ms(f, dev)
        print(f"leading-eig {name:10s}: {out[key]:8.3f} ms "
              f"for [{B},{K},{K}] ({clock})")
    vp, ve = f_pow().cpu().numpy(), f_eigh().cpu().numpy()
    cos = np.abs(np.sum(vp * ve, -1)
                 / (np.linalg.norm(vp, axis=-1) * np.linalg.norm(ve, axis=-1)))
    out["eig_median_cos"] = float(np.median(cos))
    out["eig_min_cos"] = float(cos.min())
    print(f"power-vs-eigh alignment: median |cos|={out['eig_median_cos']:.6f}"
          f" min={out['eig_min_cos']:.6f}")

    # --- study 2: Kabsch quat vs svd ----------------------------------
    A = torch.as_tensor(rng.randn(B, K, 3).astype(np.float32), device=dev)
    Bp = torch.as_tensor(rng.randn(B, K, 3).astype(np.float32), device=dev)
    w = torch.as_tensor(rng.rand(B, K).astype(np.float32), device=dev)
    for name, f, key in (("horn-quat", lambda: kabsch_quat(A, Bp, w),
                          "quat_ms"),
                         ("svd", lambda: kabsch_svd(A, Bp, w), "svd_ms")):
        out[key] = time_ms(f, dev)
        print(f"kabsch {name:10s}: {out[key]:8.3f} ms for {B} problems "
              f"({clock})")
    Tq = kabsch_quat(A, Bp, w).cpu().numpy()
    Ts = kabsch_svd(A, Bp, w).cpu().numpy()
    rot_diff = np.linalg.norm(Tq[:, :3, :3] - Ts[:, :3, :3], axis=(1, 2))
    out["kabsch_median_rot_diff"] = float(np.median(rot_diff))
    out["kabsch_max_rot_diff"] = float(rot_diff.max())
    print(f"quat-vs-svd rotation diff: median={np.median(rot_diff):.2e} "
          f"max={rot_diff.max():.2e}")
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
