"""Write gmf_tpu checkpoints into this folder with gmf_tpu's own writers,
beside gmf_tpu's outputs from them (``reference.npz``) and what it takes
to rebuild those outputs (``meta.json``):

    JAX_PLATFORMS=cpu python tests/torch_fixtures/gmf_checkpoints/make_fixtures.py

Each checkpoint directory is laid out as the gmf_tpu writer named beside
it lays one out:

- ``pointdsc_trainer/``: a small PointDSC through ``Trainer.save``
  (gmf_tpu/train/trainer.py): ``params``, ``batch_stats``, a config with
  the model's fields and no "arch";
- ``pointdsc_converted/``: the same weights through the ``convert_torch``
  command (gmf_tpu/utils/convert_torch.py), "arch": "pointdsc", from a
  reference-named torch ``state_dict``;
- ``oanet/``: a small OANet through ``convert_torch --model oanet``;
- ``fcgf/``: a narrow FCGF ``SparseResUNet2``'s bare variables, no config
  (as gmf_tpu's ``train_dgr --fcgf-checkpoint`` and ``test_dgr`` read
  one);
- ``inlier/``: a narrow 6-D GMF inlier net in ``train_dgr``'s epoch
  snapshot layout (config ``{"dgr", "descriptor"}``).

Weights are gmf_tpu's initialisation with the biases, batch-norm scales
and running statistics moved off their initial values by a seeded draw.
``reference.npz`` holds, all from gmf_tpu on the CPU in the modes its
loaders build from these checkpoints:

- ``reg_*``: PointDSCRegistrar.register_batch over REG_PAIRS pairs of up
  to REG_N correspondences (two cut shorter) for each PointDSC
  checkpoint: the inputs, the transforms and the labels;
- ``oanet_*``: OANet's logits on two pairs of those inputs;
- ``dgr_*``: DeepGlobalRegistration.register of one synthetic pair with
  the FCGF and inlier checkpoints: the clouds, frames, transform,
  weights, correspondences and safeguard flag;
- ``cli_all_stats``: ``gmf_tpu.eval.test_3dmatch`` with
  ``pointdsc_trainer`` on chip_smoke.py's phase-7 3DMatch scene
  (``write_3dmatch_scene``), whose SHA-256 is ``meta.json``'s
  ``cli_scene_sha256`` (``scene_digest``).

The card's machine has no JAX, so ``chip_smoke.py`` (phase 14) reads
these files as they are committed; ``tests/test_torch_checkpoint.py``
holds the port to them on the CPU.
"""

import contextlib
import json
import os
import shutil
import sys
import tempfile
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[2]
sys.path.insert(0, str(ROOT))

POINTDSC = dict(num_layers=2, num_channels=32, k=10, ratio=0.1,
                sigma_d=0.10, inlier_threshold=0.10)
OANET = dict(in_dim=6, num_layers=4, num_channels=16, num_clusters=5)
FCGF = dict(in_channels=1, out_channels=8, dim=3, conv1_kernel_size=7,
            normalize_feature=True, channels=(4, 4, 8, 8),
            tr_channels=(8, 8, 8, 8))
INLIER = dict(in_channels=1, out_channels=1, dim=6, conv1_kernel_size=3,
              with_gmf_fusion=True, image_dim=16, channels=(2, 2, 2, 2),
              tr_channels=(2, 2, 2, 2))
DGR_ENGINE = dict(voxel_size=0.1, voxel_cap_granule=256,
                  corr_cap_granule=256, safeguard_min_weight=0.0,
                  safeguard_min_frac=0.0, descriptor="fcgf")
DGR_PAIR = dict(seed=3, n_points=800, voxel_size=0.05, image_hw=(16, 16))
DGR_FCGF_DIM = 8
REG_PAIRS, REG_N, REG_BUCKET, REG_HW, REG_CUT = 4, 500, 512, (24, 32), \
    {1: 400, 3: 450}
SEED = 22


def perturb(tree, rng):
    """Biases, scales and running statistics off their initial values."""
    def move(path, a):
        a = np.asarray(a, np.float32)
        name = path[-1].key
        if name == "var":
            return (0.5 + rng.rand(*a.shape)).astype(np.float32)
        if name in ("mean", "bias"):
            return (0.1 * rng.randn(*a.shape)).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * rng.randn(*a.shape)).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(move, tree)


def assert_same_tree(a, b):
    la, ta = jax.tree_util.tree_flatten_with_path(a)
    lb, tb = jax.tree_util.tree_flatten_with_path(b)
    assert ta == tb, "tree structures differ"
    for (p, x), (_, y) in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                      err_msg=jax.tree_util.keystr(p))


@contextlib.contextmanager
def argv(*args):
    saved = sys.argv
    sys.argv = list(args)
    try:
        yield
    finally:
        sys.argv = saved


def write_pointdsc(rng, tmp):
    """Trainer.save's layout, then the same weights through convert_torch;
    returns gmf_tpu's variables."""
    from gmf_tpu.data.synthetic import SyntheticCorrespondenceLoader
    from gmf_tpu.models import PointDSC
    from gmf_tpu.train.trainer import TrainConfig, Trainer
    from gmf_tpu.utils import convert_torch
    from gmf_tpu.utils.checkpoint import load_checkpoint
    from gmf_tpu_torch.utils.bridge import flax_to_state_dict

    loader = SyntheticCorrespondenceLoader(batch_size=2, num_corr=64,
                                           steps_per_epoch=1,
                                           image_hw=REG_HW, seed=SEED)
    trainer = Trainer(PointDSC(**POINTDSC), TrainConfig(), loader, loader,
                      rng_seed=SEED)
    trainer.params = perturb(trainer.params, rng)
    trainer.batch_stats = perturb(trainer.batch_stats, rng)
    trainer.save(str(HERE / "pointdsc_trainer"))
    variables = {"params": jax.device_get(trainer.params),
                 "batch_stats": jax.device_get(trainer.batch_stats)}

    # the reference's names are the port's; its k=1 Conv1d weights are
    # [out, in, 1], which convert_torch reads as it reads the reference's
    sd = flax_to_state_dict(variables, POINTDSC["num_layers"])
    sd = {k: v[..., None] if v.dim() == 2 else v for k, v in sd.items()}
    torch.save(sd, tmp / "pointdsc.pth")
    with contextlib.chdir(tmp), argv(
            "convert_torch", "--input", "pointdsc.pth", "--out",
            str(HERE / "pointdsc_converted"), "--model", "pointdsc",
            "--num-layers", str(POINTDSC["num_layers"])):
        convert_torch.main()
    assert_same_tree(load_checkpoint(str(HERE / "pointdsc_converted"))[0],
                     variables)
    return variables


def write_oanet(rng, tmp):
    """A reference-named OANet state_dict through convert_torch."""
    from gmf_tpu.models.oanet import OANet
    from gmf_tpu.utils import convert_torch
    from gmf_tpu_torch.utils.bridge import oanet_to_state_dict

    v = jax.eval_shape(lambda: OANet(**OANET).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, OANET["in_dim"]))))
    shapes = oanet_to_state_dict(
        jax.tree.map(lambda s: np.zeros(s.shape, np.float32), v),
        OANET["num_layers"])
    sd = {}
    for k, t in shapes.items():
        if k.endswith("num_batches_tracked"):
            sd[k] = t
        elif k.endswith("running_var"):
            sd[k] = torch.tensor(0.5 + rng.rand(*t.shape), dtype=torch.float32)
        elif t.dim() == 2:
            sd[k] = torch.tensor(rng.randn(*t.shape) / np.sqrt(t.shape[1]),
                                 dtype=torch.float32)[..., None]
        else:
            sd[k] = torch.tensor(0.1 * rng.randn(*t.shape) + ("weight" in k),
                                 dtype=torch.float32)
    torch.save(sd, tmp / "oanet.pth")
    with contextlib.chdir(tmp), argv(
            "convert_torch", "--input", "oanet.pth", "--out",
            str(HERE / "oanet"), "--model", "oanet", "--num-layers",
            str(OANET["num_layers"])):
        convert_torch.main()


def write_dgr_nets(rng):
    """The FCGF net's bare variables and the inlier net's epoch snapshot
    (gmf_tpu/train/train_dgr.py:213-216)."""
    from gmf_tpu.configs.presets import dgr_3dmatch
    from gmf_tpu.sparse.kernel_map import build_pyramid
    from gmf_tpu.sparse.resunet import SparseResUNet2, pyramid_to_arrays
    from gmf_tpu.utils.checkpoint import save_checkpoint

    r = np.random.RandomState(SEED)
    c3 = np.unique(r.randint(0, 10, (80, 3)).astype(np.int32), axis=0)
    a3 = pyramid_to_arrays(build_pyramid(c3, 4, FCGF["conv1_kernel_size"],
                                         granule=256))
    fv = jax.jit(SparseResUNet2(**FCGF).init)(
        jax.random.PRNGKey(0), jnp.ones((a3["mask_0"].shape[0], 1)), a3)
    c6 = np.unique(r.randint(0, 6, (60, 6)).astype(np.int32), axis=0)
    a6 = pyramid_to_arrays(build_pyramid(c6, 4, 3, granule=256))
    img = jnp.zeros((1, *DGR_PAIR["image_hw"], 3))
    iv = jax.jit(SparseResUNet2(**INLIER).init)(
        jax.random.PRNGKey(1), jnp.ones((a6["mask_0"].shape[0], 1)), a6,
        p_image=img, q_image=img)
    save_checkpoint(str(HERE / "fcgf"), perturb(dict(fv), rng))
    save_checkpoint(str(HERE / "inlier"), perturb(dict(iv), rng),
                    config={"dgr": dgr_3dmatch().__dict__,
                            "descriptor": "fcgf"})


def registrar_inputs():
    from gmf_tpu.data.synthetic import make_correspondence_problem

    prob = make_correspondence_problem(
        np.random.RandomState(SEED), num_corr=REG_N, inlier_ratio=0.4,
        image_hw=REG_HW, batch=REG_PAIRS)
    samples = [{k: v[b] for k, v in prob.items()} for b in range(REG_PAIRS)]
    for b, n in REG_CUT.items():
        for key in ("corr_pos", "src_keypts", "tgt_keypts", "labels"):
            samples[b][key] = samples[b][key][:n]
    return prob, samples


def reference_outputs(tmp):
    from gmf_tpu.data.dgr_loader import make_dgr_pair
    from gmf_tpu.eval import test_3dmatch
    from gmf_tpu.eval.registration import PointDSCRegistrar
    from gmf_tpu.models import dgr
    from gmf_tpu.models.oanet import OANet
    from gmf_tpu.sparse.resunet import SparseResUNet2
    from gmf_tpu.utils.checkpoint import load_checkpoint
    from gmf_tpu.utils.model_io import load_pointdsc

    import chip_smoke

    out = {}
    prob, samples = registrar_inputs()
    for k in ("corr_pos", "src_keypts", "tgt_keypts", "p_image", "q_image",
              "gt_trans", "labels"):
        out[f"reg_{k}"] = prob[k]
    out["reg_n"] = np.array([len(s["corr_pos"]) for s in samples])
    for name in ("pointdsc_trainer", "pointdsc_converted"):
        model, variables = load_pointdsc(str(HERE / name))
        res = PointDSCRegistrar(model, variables, buckets=(REG_BUCKET,)
                                ).register_batch(samples)
        out[f"reg_{name}_trans"] = np.stack([np.asarray(t) for t, _ in res])
        labels = np.zeros((REG_PAIRS, REG_N), np.float32)
        for b, (_, lab) in enumerate(res):
            labels[b, :len(lab)] = np.asarray(lab)
        out[f"reg_{name}_labels"] = labels

    variables, _ = load_checkpoint(str(HERE / "oanet"))
    out["oanet_logits"] = np.asarray(OANet(**OANET).apply(
        variables, jnp.asarray(prob["corr_pos"][[0, 2]]),
        return_logits=True))

    pair = make_dgr_pair(np.random.RandomState(DGR_PAIR["seed"]),
                         n_points=DGR_PAIR["n_points"],
                         voxel_size=DGR_PAIR["voxel_size"], surface=True,
                         image_hw=DGR_PAIR["image_hw"])
    fv, _ = load_checkpoint(str(HERE / "fcgf"))
    iv, _ = load_checkpoint(str(HERE / "inlier"))
    engine = dgr.DeepGlobalRegistration(
        fv, iv, dgr.DGRConfig(image_hw=DGR_PAIR["image_hw"], **DGR_ENGINE),
        fcgf_model=SparseResUNet2(**FCGF),
        inlier_model=SparseResUNet2(**INLIER), fcgf_dim=DGR_FCGF_DIM)
    args = (pair["pcd0"], pair["pcd1"], pair["p_image"][None],
            pair["q_image"][None])
    res = engine.register(*args)
    for k, a in zip(("pcd0", "pcd1", "p_image", "q_image"), args):
        out[f"dgr_{k}"] = np.asarray(a)
    out["dgr_trans"] = np.asarray(res["trans"])
    out["dgr_weights"] = np.asarray(res["weights"])
    out["dgr_idx0"], out["dgr_idx1"] = map(np.asarray, res["corres"])
    out["dgr_used_safeguard"] = np.array(bool(res["used_safeguard"]))

    root = tmp / "data"
    scene, _ = chip_smoke.write_3dmatch_scene(
        str(root), np.random.RandomState(chip_smoke.SEED + 7))
    with argv("test_3dmatch", "--root", str(root), "--checkpoint",
              str(HERE / "pointdsc_trainer"), "--scenes", scene, "--out",
              str(tmp / "e3dm")):
        test_3dmatch.main()
    out["cli_all_stats"] = np.load(tmp / "e3dm" / "all_stats.npy")
    return out, scene, chip_smoke.scene_digest(str(root), scene)


def main():
    rng = np.random.RandomState(SEED)
    for name in ("pointdsc_trainer", "pointdsc_converted", "oanet", "fcgf",
                 "inlier"):
        shutil.rmtree(HERE / name, ignore_errors=True)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        write_pointdsc(rng, tmp)
        write_oanet(rng, tmp)
        write_dgr_nets(rng)
        out, scene, digest = reference_outputs(tmp)
    np.savez(HERE / "reference.npz", **out)
    meta = dict(pointdsc=POINTDSC, oanet=OANET, fcgf=FCGF, inlier=INLIER,
                dgr_engine=DGR_ENGINE, dgr_pair=DGR_PAIR,
                dgr_fcgf_dim=DGR_FCGF_DIM, reg_bucket=REG_BUCKET,
                cli_scene=scene, cli_scene_sha256=digest)
    with open(HERE / "meta.json", "w") as f:
        json.dump(meta, f, indent=1)
    for p in sorted(HERE.rglob("*")):
        if p.is_file() and p.suffix != ".py":
            print(f"{p.relative_to(HERE)}: {p.stat().st_size} bytes")


if __name__ == "__main__":
    main()
