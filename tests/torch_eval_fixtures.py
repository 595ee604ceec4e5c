"""Fixture trees and bridged checkpoints shared by tests/test_torch_data.py
and tests/test_torch_eval.py: a 3DMatch scene of three fragments (a
gt.log of their three pairs, overlap and split files, a 3DLoMatch pair
file over the same fragments), KITTI pairs in the npz-per-pair layout,
and one tiny PointDSC saved by gmf_tpu and, bridged, by the port. Every
array comes from a numpy seed."""

import os
import pickle

import numpy as np

SCENE = "7-scenes-redkitchen"
TRAIN_SCENE = "sun3d-brown_bm_1-brown_bm_1"  # first of splits/train_3dmatch
VAL_SCENE = "sun3d-brown_bm_4-brown_bm_4"  # first of splits/val_3dmatch
TINY = {"num_layers": 1, "num_channels": 16, "k": 10}
PAIRS = ((0, 1), (0, 2), (1, 2))


def _rot(a, b):
    ca, sa, cb, sb = np.cos(a), np.sin(a), np.cos(b), np.sin(b)
    return (np.array([[ca, -sa, 0], [sa, ca, 0], [0, 0, 1]])
            @ np.array([[cb, 0, sb], [0, 1, 0], [-sb, 0, cb]]))


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def _png(path, rng, hw, gray=False):
    import matplotlib.image as mpimg

    shape = hw if gray else hw + (3,)
    mpimg.imsave(path, (rng.rand(*shape) * 255).astype(np.uint8),
                 cmap="gray" if gray else None)


def write_3dmatch_tree(root, seed=0, sizes=(180, 170, 160), scene_pts=240,
                       desc_dim=16, image_hw=(48, 64)):
    """Three fragments of one synthetic scene in the 3DImageMatch layout;
    returns dict(root, scene, pair_file, overlap_path, split_file)."""
    rng = np.random.RandomState(seed)
    seq = os.path.join(root, SCENE, "seq-01")
    os.makedirs(seq, exist_ok=True)
    world = rng.rand(scene_pts, 3) * 2.0
    desc = rng.randn(scene_pts, desc_dim)
    poses = []
    for f, n in enumerate(sizes):
        idx = rng.choice(scene_pts, n, replace=False)
        P = np.eye(4)
        P[:3, :3] = _rot(0.3 * f + 0.1, 0.2 * f)
        P[:3, 3] = rng.rand(3)
        pts = (world[idx] - P[:3, 3]) @ P[:3, :3] + 0.005 * rng.randn(n, 3)
        base = os.path.join(seq, f"cloud_bin_{f}")
        np.savez(base + "_fcgf.npz", xyz=pts.astype(np.float32),
                 feature=_unit(desc[idx] + 0.6 * rng.randn(n, desc_dim)))
        _png(base + "_0.png", rng, image_hw, gray=f == 2)
        poses.append(P)
    gt = {(i, j): np.linalg.inv(poses[j]) @ poses[i] for i, j in PAIRS}
    with open(os.path.join(root, SCENE, "gt.log"), "w") as f:
        for (i, j), T in gt.items():  # gt.log stores target->source
            f.write(f"{i} {j} {len(sizes)}\n")
            for row in np.linalg.inv(T):
                f.write(" ".join(f"{v:.10f}" for v in row) + "\n")
    # overlap files: the fixture scene's (for ``split_file``) and, over
    # the same fragments, the first scene of the shipped train and val
    # splits (for the training command line)
    overlap = os.path.join(root, "overlap")
    os.makedirs(overlap, exist_ok=True)
    for name, pairs in ((SCENE, PAIRS), (TRAIN_SCENE, PAIRS),
                        (VAL_SCENE, PAIRS[:1])):
        with open(os.path.join(overlap, f"{name}-0.txt"), "w") as f:
            for i, j in pairs:
                f.write(f"{SCENE}/seq-01/cloud_bin_{i}.ply "
                        f"{SCENE}/seq-01/cloud_bin_{j}.ply 0.5\n")
    split_file = os.path.join(root, "split.txt")
    with open(split_file, "w") as f:
        f.write(SCENE + "\n")
    infos = {
        "rot": np.stack([gt[p][:3, :3] for p in PAIRS]),
        "trans": np.stack([gt[p][:3, 3:4] for p in PAIRS]),
        "src": np.array([f"{SCENE}/seq-01/cloud_bin_{i}.pth"
                         for i, _ in PAIRS]),
        "tgt": np.array([f"{SCENE}/seq-01/cloud_bin_{j}.pth"
                         for _, j in PAIRS]),
    }
    pair_file = os.path.join(root, "3DLoMatch.pkl")
    with open(pair_file, "wb") as f:
        pickle.dump(infos, f)
    return dict(root=root, scene=SCENE, pair_file=pair_file,
                overlap_path=overlap, split_file=split_file)


def write_kitti_tree(root, seed=0, splits=("test",), pairs=2, n=200,
                     image_hw=(48, 64)):
    """``pairs`` pairs a split in ``{root}/fcgf_{split}/``: a source cloud
    in a 20 m box, its target under a known transform with a third of the
    points replaced, shared unit features with noise, uint8 frames that
    need a resize."""
    rng = np.random.RandomState(seed)
    for split in splits:
        d = os.path.join(root, f"fcgf_{split}")
        os.makedirs(d, exist_ok=True)
        for p in range(pairs):
            xyz0 = rng.rand(n, 3) * 20.0
            T = np.eye(4)
            T[:3, :3] = _rot(0.2 + 0.1 * p, 0.05)
            T[:3, 3] = rng.rand(3) * 2.0
            xyz1 = xyz0 @ T[:3, :3].T + T[:3, 3] + 0.02 * rng.randn(n, 3)
            out = rng.choice(n, n // 3, replace=False)
            xyz1[out] = rng.rand(len(out), 3) * 20.0
            feat = rng.randn(n, 16)
            np.savez(os.path.join(d, f"pair_{p:06d}.npz"),
                     xyz0=xyz0.astype(np.float32),
                     xyz1=xyz1.astype(np.float32),
                     features0=_unit(feat + 0.1 * rng.randn(n, 16)),
                     features1=_unit(feat + 0.1 * rng.randn(n, 16)),
                     p_image=(rng.rand(*image_hw, 3) * 255).astype(np.uint8),
                     q_image=(rng.rand(*image_hw, 3) * 255).astype(np.uint8),
                     gt_trans=T.astype(np.float32))
    return root


def jax_variables(seed=0):
    """gmf_tpu's tiny PointDSC init, with batch-norm statistics away from
    their init so that eval mode reads them."""
    import jax
    import jax.numpy as jnp

    from gmf_tpu.models import PointDSC as JaxPointDSC

    z = jnp.zeros
    v = jax.jit(JaxPointDSC(**TINY).init)(
        jax.random.PRNGKey(seed), z((1, 32, 6)), z((1, 32, 3)),
        z((1, 32, 3)), z((1, 24, 32, 3)), z((1, 24, 32, 3)))
    v = jax.tree_util.tree_map(np.asarray, v)
    rng = np.random.RandomState(seed + 3)
    v["batch_stats"] = jax.tree_util.tree_map_with_path(
        lambda p, a: (0.5 + rng.rand(*a.shape) if p[-1].key == "var"
                      else 0.1 * rng.randn(*a.shape)).astype(np.float32),
        v["batch_stats"])
    return v


def write_checkpoints(directory, name="ckpt", seed=0, model=None):
    """The same weights as a gmf_tpu checkpoint and, through the bridge,
    a port checkpoint: (jax_path, port_path). ``model``: settings the
    port's config records on top of the tiny widths."""
    from gmf_tpu.utils.checkpoint import save_checkpoint as jax_save
    from gmf_tpu_torch.utils.bridge import flax_to_state_dict
    from gmf_tpu_torch.utils.checkpoint import save_checkpoint

    v = jax_variables(seed)
    jax_path = os.path.join(directory, "jax", name)
    port_path = os.path.join(directory, "port", name)
    jax_save(jax_path, {"params": v["params"],
                        "batch_stats": v["batch_stats"]},
             config={"model": dict(TINY)})
    save_checkpoint(port_path, flax_to_state_dict(v, TINY["num_layers"]),
                    config={"model": {**TINY, **(model or {})}})
    return jax_path, port_path
