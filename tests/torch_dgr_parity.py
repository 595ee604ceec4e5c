"""Shared set-up of the DGR training parity tests
(tests/test_torch_dgr_train.py, tests/test_torch_dgr_bf16.py): gmf_tpu's
tiny DGR nets and trainers, the port's on bridged weights, and the
comparisons. See tests/test_torch_dgr_train.py for the widths, the
pairs and the tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gmf_tpu.configs.presets import DGRTrainConfig as JaxTrainConfig
from gmf_tpu.data.dgr_loader import make_dgr_pair
from gmf_tpu.sparse.kernel_map import build_pyramid as jax_build_pyramid
from gmf_tpu.sparse.resunet import SparseResUNet2 as JaxNet
from gmf_tpu.sparse.resunet import pyramid_to_arrays as jax_arrays
from gmf_tpu.train import dgr_trainer as jdt
from gmf_tpu_torch.configs.presets import DGRTrainConfig
from gmf_tpu_torch.sparse.resunet import SparseResUNet2
from gmf_tpu_torch.train.dgr_trainer import WeightedProcrustesTrainer
from gmf_tpu_torch.utils.bridge import sparse_resunet_to_state_dict

NARROW = dict(channels=(4, 8, 16, 32), tr_channels=(8, 8, 8, 16))
FKW = dict(in_channels=1, out_channels=8, dim=3, conv1_kernel_size=3,
           normalize_feature=True, **NARROW)
IKW = dict(in_channels=1, out_channels=1, dim=6, conv1_kernel_size=3,
           with_gmf_fusion=True, image_dim=16, **NARROW)
G = 256
GRAD_TOL = 1e-4    # of each leaf's largest |entry|
STATE_TOL = 1e-5   # batch statistics and parameters
METRIC_RTOL = 1e-5


def jax_vars():
    """gmf_tpu's tiny nets' variables (tests/test_dgr_trainer.py::
    tiny_nets, init jitted), as NumPy."""
    rng = np.random.RandomState(9)
    coords = np.unique(rng.randint(0, 12, (100, 3)).astype(np.int32), axis=0)
    a3 = jax_arrays(jax_build_pyramid(coords, 4, granule=G))
    fv = jax.jit(JaxNet(**FKW).init)(
        jax.random.PRNGKey(0), jnp.ones((a3["mask_0"].shape[0], 1)), a3)
    coords6 = np.unique(rng.randint(0, 8, (80, 6)).astype(np.int32), axis=0)
    a6 = jax_arrays(jax_build_pyramid(coords6, 4, granule=G))
    img = jnp.zeros((1, 16, 16, 3))
    iv = jax.jit(JaxNet(**IKW).init)(
        jax.random.PRNGKey(1), jnp.ones((a6["mask_0"].shape[0], 1)), a6,
        p_image=img, q_image=img)
    iv = dict(iv)
    # non-trivial running statistics, so that train mode's update shows
    r = np.random.RandomState(4)
    iv["batch_stats"] = jax.tree_util.tree_map_with_path(
        lambda p, a: (0.5 + r.rand(*a.shape) if p[-1].key == "var"
                      else 0.1 * r.randn(*a.shape)).astype(np.float32),
        iv["batch_stats"])
    return jax.tree.map(np.asarray, fv), jax.tree.map(np.asarray, iv)


def pad_maps(arrays):
    """Every kernel map padded to its full kernel volume with all-sentinel
    rows (kept id 0), so that every pair has one shape (the caps are one
    bucket, so each map's sentinel is that cap)."""
    arrays = dict(arrays)
    caps = {int(arrays[k].shape[0]) for k in arrays if k.startswith("mask_")}
    assert caps == {G}, caps
    dim = 6 if arrays["self_map_0"].shape[0] > 27 else 3
    for key in [k for k in arrays if "_map" in k]:
        m = np.asarray(arrays[key])
        kept = np.asarray(arrays[key.replace("_map", "_kept")])
        pad = 3 ** dim - m.shape[0]
        arrays[key] = jnp.asarray(np.concatenate(
            [m, np.full((pad, m.shape[1]), G, m.dtype)]))
        arrays[key.replace("_map", "_kept")] = jnp.asarray(np.concatenate(
            [kept, np.zeros(pad, kept.dtype)]))
    return arrays


def make_pairs(seeds):
    return [make_dgr_pair(np.random.RandomState(s), n_points=300,
                          voxel_size=0.08, image_hw=(16, 16), surface=True)
            for s in seeds]


def check_matching(port_out, jax_out):
    """generate_inlier_input of both packages: FCGF features within 1e-5;
    a 1-NN match may differ only where the two candidates' distances lie
    within 1e-5 (the tiny nets' 8-d random features nearly tie, and the
    packages' features differ in the last bits); labels equal wherever
    the matches are."""
    (pred, ok, F0, F1), (jpred, jok, jF0, jF1) = port_out, jax_out
    for a, b in ((F0, jF0), (F1, jF1)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-5)
    jF0, jF1 = np.asarray(jF0, np.float64), np.asarray(jF1, np.float64)
    for i in np.flatnonzero(pred[:, 1] != jpred[:, 1]):
        d = ((jF1[[pred[i, 1], jpred[i, 1]]] - jF0[i]) ** 2).sum(-1)
        assert abs(d[0] - d[1]) <= 1e-5, (i, d)
    same = pred[:, 1] == jpred[:, 1]
    np.testing.assert_array_equal(ok[same], jok[same])


def share_matches(pt, jt):
    """The port trainer takes gmf_tpu's 1-NN matches and labels (with its
    own features, which ``check_matching`` holds first), so that both
    packages train on the same correspondences."""
    own = pt.generate_inlier_input

    def generate(pair):
        out, jout = own(pair), jt.generate_inlier_input(pair)
        check_matching(out, jout)
        return jout[0], jout[1], out[2], out[3]

    pt.generate_inlier_input = generate
    return pt


class JaxSide:
    """gmf_tpu's trainers on the tiny nets, sharing one jitted pair
    gradient and one jitted FCGF forward."""

    def __init__(self, fv, iv):
        self.fv, self.iv = fv, iv
        self.shared = None

    def trainer(self, **cfg):
        t = jdt.WeightedProcrustesTrainer(
            JaxNet(**FKW), self.fv, JaxNet(**IKW), self.iv,
            JaxTrainConfig(feat_conv1_kernel_size=3, **cfg),
            voxel_cap_granule=G, corr_cap_granule=G, steps_per_epoch=1)
        orig = t._pyramid_arrays
        t._pyramid_arrays = lambda *a, **k: pad_maps(orig(*a, **k))
        if self.shared is None:
            self.shared = (t._pair_grads, t._fcgf_apply)
        t._pair_grads, t._fcgf_apply = self.shared
        return t


def port_trainer(fv, iv, jt=None, **cfg):
    """The port's trainer on the bridged weights; with gmf_tpu's trainer
    ``jt``, on its matches (``share_matches``)."""
    fcgf, inlier = SparseResUNet2(**FKW), SparseResUNet2(**IKW)
    fcgf.load_state_dict(sparse_resunet_to_state_dict(fv), strict=True)
    inlier.load_state_dict(sparse_resunet_to_state_dict(iv), strict=True)
    pt = WeightedProcrustesTrainer(
        fcgf, inlier, DGRTrainConfig(**cfg), voxel_cap_granule=G,
        corr_cap_granule=G, steps_per_epoch=1, device="cpu")
    return pt if jt is None else share_matches(pt, jt)


def jax_state(t):
    """A gmf_tpu trainer's inlier variables as the port's state dict."""
    return sparse_resunet_to_state_dict(jax.tree.map(
        np.asarray, t.inlier_variables()))


def assert_state(port, want, what):
    """The port net's parameters and running statistics against a
    bridged gmf_tpu state dict, within STATE_TOL."""
    got = port.inlier.state_dict()
    for k, v in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0,
                                   atol=STATE_TOL, err_msg=f"{what} {k}")


def assert_metrics(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=METRIC_RTOL, atol=1e-6,
                                   err_msg=k)


def make_world():
    """The module fixture's contents: both nets' variables, gmf_tpu's
    trainers and two pairs."""
    fv, iv = jax_vars()
    return dict(fv=fv, iv=iv, jax=JaxSide(fv, iv), pairs=make_pairs([11, 12]))
