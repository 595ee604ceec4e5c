"""Close the train -> checkpoint -> eval loop of both pipelines on
synthetic data, on the port, and print the evidence.

Counterpart of ``scripts/train_eval_synthetic.py``: runs the port's
training command lines (``train_pointdsc`` and ``train_dgr``,
``--dataset synthetic``) with that script's arguments, writing
``gmf_tpu``'s checkpoints (``--checkpoint-format gmf``), loads them and
evaluates them through the port:

- PointDSC: checkpoint -> ``load_pointdsc`` -> ``PointDSCRegistrar`` ->
  ``evaluate_pairs`` on 8 held-out pairs (recall, RE, TE), and the
  classifier's confidence BCE on the ground-truth labels, trained against
  an untrained model of the same settings;
- DGR: FPFH descriptors on surface clouds, checkpoint ->
  ``WeightedProcrustesTrainer.validate`` of the untrained and the trained
  inlier net on 4 held-out pairs.

    python -m gmf_tpu_torch.tools.train_eval_synthetic [--cpu]

It runs on the card unless ``--cpu`` is given. ``--max-epoch`` and
``--steps-per-epoch`` cut both trainings (default: the script's, 3 x 8
and 2 x 2); ``--save-dir`` keeps the snapshots (default: a temporary
directory).
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU through the plain versions")
    ap.add_argument("--max-epoch", type=int, default=None,
                    help="epochs of each training (default 3 and 2)")
    ap.add_argument("--steps-per-epoch", type=int, default=None,
                    help="steps an epoch of each training (default 8 and 2)")
    ap.add_argument("--save-dir", default=None,
                    help="the snapshots' parent directory (default: a new "
                         "temporary one)")
    return ap.parse_args(argv)


def _bce(conf, labels):
    p = np.clip(conf, 1e-6, 1 - 1e-6)
    return float(-(labels * np.log(p) + (1 - labels) * np.log(1 - p)).mean())


def _cut(args, epochs, steps):
    return ["--max-epoch", str(args.max_epoch or epochs),
            "--steps-per-epoch", str(args.steps_per_epoch or steps)]


def _common(args):
    return ["--dataset", "synthetic", "--tiny", "--checkpoint-format",
            "gmf"] + (["--cpu"] if args.cpu else [])


def pointdsc_loop(args, device, root):
    """Train, load the best checkpoint, evaluate (module docstring);
    returns the numbers printed."""
    import torch

    from gmf_tpu_torch.data.synthetic import make_correspondence_problem
    from gmf_tpu_torch.eval.harness import evaluate_pairs
    from gmf_tpu_torch.eval.registration import PointDSCRegistrar
    from gmf_tpu_torch.eval.solvers import make_register_fn
    from gmf_tpu_torch.models import PointDSC
    from gmf_tpu_torch.train import train_pointdsc
    from gmf_tpu_torch.utils.model_io import load_pointdsc

    save = tempfile.mkdtemp(prefix="pointdsc_loop_", dir=root)
    t0 = time.time()
    train_pointdsc.main(_common(args) + _cut(args, 3, 8) + [
        "--batch-size", "8", "--save-dir", save, "--lr", "1e-3"])
    t_train = time.time() - t0

    model = load_pointdsc(os.path.join(save, "model_best"), device=device)
    rng = np.random.RandomState(999)
    pairs = []
    for _ in range(8):
        b = make_correspondence_problem(rng, num_corr=256, batch=1,
                                        inlier_ratio=0.5, image_hw=(24, 32))
        pairs.append({k: v[0] for k, v in b.items()})

    reg = PointDSCRegistrar(model, buckets=(256,))
    stats = evaluate_pairs(make_register_fn(reg), iter(pairs))
    fresh = PointDSC(**model.config, seed=7, device=device)

    def mean_conf_bce(net):
        tot = []
        with torch.no_grad():
            for p in pairs:
                x = [torch.from_numpy(np.asarray(p[k], np.float32)[None]).to(
                    device) for k in ("corr_pos", "src_keypts", "tgt_keypts",
                                      "p_image", "q_image")]
                out = net(*x, testing=False)
                tot.append(_bce(out["confidence"][0].float().cpu().numpy(),
                                p["labels"]))
        return float(np.mean(tot))

    ok = stats[stats[:, 0] > 0]
    res = dict(save_dir=save, train_s=t_train,
               recall=float(stats[:, 0].mean()),
               re_deg=float(ok[:, 1].mean()) if len(ok) else float("nan"),
               te_cm=float(ok[:, 2].mean()) if len(ok) else float("nan"),
               bce_trained=mean_conf_bce(model),
               bce_untrained=mean_conf_bce(fresh))
    print(f"\n=== PointDSC+GMF synthetic loop (train {t_train:.0f} s) ===")
    print(f"held-out recall through the eval harness: "
          f"{res['recall'] * 100:.1f}%  "
          f"(RE {res['re_deg']:.2f} deg, TE {res['te_cm']:.2f} cm)")
    print(f"classifier confidence BCE: trained {res['bce_trained']:.4f}"
          f" vs untrained {res['bce_untrained']:.4f}", flush=True)
    return res


def dgr_loop(args, device, root):
    """Train the inlier net on FPFH, load its best checkpoint, validate
    the untrained and the trained net; returns both validations."""
    import torch

    from gmf_tpu_torch.configs.presets import dgr_3dmatch
    from gmf_tpu_torch.data.dgr_loader import make_dgr_pair
    from gmf_tpu_torch.eval.test_dgr import tiny_nets
    from gmf_tpu_torch.train import train_dgr
    from gmf_tpu_torch.train.dgr_trainer import WeightedProcrustesTrainer
    from gmf_tpu_torch.utils.model_io import load_state

    save = tempfile.mkdtemp(prefix="dgr_loop_", dir=root)
    t0 = time.time()
    train_dgr.main(_common(args) + _cut(args, 2, 2) + [
        "--descriptor", "fpfh", "--cloud", "surface", "--n-points", "600",
        "--batch-size", "4", "--save-dir", save])
    t_train = time.time() - t0

    torch.manual_seed(0)  # the nets train_dgr started from
    fcgf, inlier = tiny_nets()
    cfg = dgr_3dmatch()
    rng = np.random.RandomState(123)
    held = [make_dgr_pair(rng, n_points=600, voxel_size=cfg.voxel_size,
                          image_hw=(16, 16), surface=True)
            for _ in range(4)]

    def validate(net):
        return WeightedProcrustesTrainer(
            fcgf, net, cfg, voxel_cap_granule=256, corr_cap_granule=256,
            descriptor="fpfh", device=device).validate(held)

    v0 = validate(inlier)
    trained = tiny_nets()[1]
    trained.load_state_dict(load_state(
        os.path.join(save, "best_val_checkpoint"), "sparse")[0], strict=True)
    v1 = validate(trained)

    print(f"\n=== DGR+GMF synthetic loop (fpfh/surface, train "
          f"{t_train:.0f} s) ===")
    for name, v in [("untrained", v0), ("trained", v1)]:
        print(f"{name}: success {v['success'] * 100:.0f}%  "
              f"rte {v['rte']:.3f} m  rre {v['rre']:.2f} deg  "
              f"inlier P {v['precision']:.3f} R {v['recall']:.3f} "
              f"F1 {v['f1']:.3f}  (hit ratio {v['hit_ratio']:.3f})",
              flush=True)
    return dict(save_dir=save, train_s=t_train, untrained=v0, trained=v1)


def main(argv=None):
    """Both loops (module docstring); returns {"pointdsc", "dgr"}."""
    args = parse_args(argv)
    from gmf_tpu_torch.utils.device import resolve_device

    device = resolve_device("cpu" if args.cpu else None)
    root = args.save_dir
    if root:
        os.makedirs(root, exist_ok=True)
    return dict(pointdsc=pointdsc_loop(args, device, root),
                dgr=dgr_loop(args, device, root))


if __name__ == "__main__":
    main()
