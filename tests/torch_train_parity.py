"""The port's training step vs gmf_tpu's ``make_train_step``, on the CPU:
the checks, shared by tests/test_torch_train*.py, one file per
``compat_cache`` mode so that each file's JAX compile stays short.

Both packages start from the same weights (gmf_tpu's init, carried over
by ``utils/bridge.py``) and take two steps on the same batches: JAX with
``PointDSC(fused_attention=True, knn_topk="fused", hypo_scoring="fused",
compat_cache=mode)`` and its Pallas kernels in interpret mode, the port
through its kernels' plain versions in the same mode. Between the two
steps each side meets a batch with a NaN keypoint, which both must skip.
``steps_per_epoch=1``, so the second step's learning rate is already
decayed once.

Compared: the loss and every metric; the first step's gradients (read on
the JAX side from Adam's first moment, mu = 0.1 (g + wd p)) at
2e-3 * scale + 1e-6, the bound of tests/test_fused_model.py; the new
parameters and batch-norm statistics after each step.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gmf_tpu.models import PointDSC as JaxPointDSC
from gmf_tpu.ops import fused_attention as jattn
from gmf_tpu.train.trainer import TrainConfig as JaxTrainConfig
from gmf_tpu.train.trainer import make_optimizer, make_train_step
from gmf_tpu_torch.data.synthetic import make_correspondence_problem
from gmf_tpu_torch.models import PointDSC
from gmf_tpu_torch.models import pointdsc as port_pointdsc
from gmf_tpu_torch.ops.fused_attention import cache_row_stride
from gmf_tpu_torch.train.trainer import TrainConfig, Trainer
from gmf_tpu_torch.utils.bridge import flax_to_state_dict

THREADS = 1  # the thread count BATCHES were chosen at (see there)
torch.set_num_threads(THREADS)

KW = dict(num_layers=2, num_channels=32, ratio=0.1, k=10, sigma_d=0.10)
B, N = 2, 100  # N: no multiple of the 64/128 blocks


def _batch(seed):
    """A synthetic batch; pair 1 has its last 20 rows masked (zeroed, as
    the bucket padding leaves them)."""
    b = make_correspondence_problem(np.random.RandomState(seed), num_corr=N,
                                    inlier_ratio=0.5, image_hw=(16, 16),
                                    batch=B)
    mask = np.ones((B, N), np.float32)
    mask[1, N - 20:] = 0.0
    for k in ("corr_pos", "src_keypts", "tgt_keypts", "labels"):
        b[k] = b[k] * (mask[..., None] if b[k].ndim == 3 else mask)
    b["corr_mask"] = mask
    return b


def _nan_batch():
    b = _batch(5)
    b["src_keypts"] = b["src_keypts"].copy()
    b["src_keypts"][0, 3, 1] = np.nan
    return b


# The gradient is discontinuous where a ReLU input is 0, and the two
# packages' forwards agree to ~1e-4 at a batch norm's output: an input
# closer than that to 0 may fall on either side, and the batch norm before
# it then spreads the difference over its whole channel. With batches 1
# and 2 one such input (+9.8e-6 in JAX, -2.6e-5 here) moved the int8
# step's image-encoder gradient by 9.6e-3 of the largest (f32 and off:
# 2e-5). These batches have no flip that matters, at one CPU thread (the
# sums' order, and with it such a sign, depends on the thread count), so
# _port_steps pins THREADS and asserts it.
BATCHES = (_batch(11), _nan_batch(), _batch(12))


def _initial_variables():
    b = BATCHES[0]
    model = JaxPointDSC(fused_attention=True, **KW)
    v = model.init(jax.random.PRNGKey(0), *(jnp.asarray(b[k]) for k in (
        "corr_pos", "src_keypts", "tgt_keypts", "p_image", "q_image")))
    return jax.tree_util.tree_map(np.asarray, v)


# the model modes of the comparison unless run_steps is given others
FUSED = dict(fused_attention=True, knn_topk="fused", hypo_scoring="fused")


def _jax_steps(mode, variables, modes=FUSED):
    """gmf_tpu's jitted train step over BATCHES: per step (metrics,
    params, batch_stats, gradients or None)."""
    model = JaxPointDSC(compat_cache=mode, **modes, **KW)
    cfg = JaxTrainConfig()
    opt = make_optimizer(cfg, steps_per_epoch=1)
    step = jax.jit(make_train_step(model, opt, cfg))
    params, stats = variables["params"], variables["batch_stats"]
    opt_state = opt.init(params)
    out = []
    for i, batch in enumerate(BATCHES):
        old = params
        params, stats, opt_state, metrics = step(
            params, stats, opt_state, {k: jnp.asarray(v)
                                       for k, v in batch.items()},
            jnp.asarray(1))
        grads = None
        if i == 0:  # Adam's first moment after one step is 0.1 (g + wd p)
            mu = opt_state[1][0].mu
            grads = jax.tree_util.tree_map(
                lambda m, p: np.asarray(m) / 0.1 - cfg.weight_decay
                * np.asarray(p), mu, old)
        out.append(({k: float(v) for k, v in metrics.items()},
                    jax.tree_util.tree_map(np.asarray, params),
                    jax.tree_util.tree_map(np.asarray, stats), grads))
    return out


def _jax_int8_cache(src, tgt, sigma_d, dtype):
    """gmf_tpu's int8 cache of each pair (its Pallas builder, interpret
    mode) in the port's [B, N, ld] layout."""
    assert dtype == torch.int8
    B, N, _ = src.shape
    cache = torch.zeros(B, N, cache_row_stride(N, dtype), dtype=dtype)
    for b in range(B):
        c = jattn.build_compat_cache(jnp.asarray(src[b].numpy()),
                                     jnp.asarray(tgt[b].numpy()),
                                     sigma_d=sigma_d, dtype=jnp.int8,
                                     interpret=True)
        cache[b, :, :N] = torch.tensor(np.asarray(c)[:N, :N])
    return cache


def _port_steps(mode, variables, modes=FUSED):
    """The port's Trainer over BATCHES: per step (metrics, state_dict,
    gradients by parameter name). In int8 mode the port's model gets
    gmf_tpu's int8 codes: the two builders round a small share of them
    one code apart (tests/test_torch_ops.py), and a step's gradients
    amplify that beyond the bound, so the comparison holds the training
    path to one cache, as tests/test_torch_attention_bwd.py does."""
    torch.set_num_threads(THREADS)
    model = PointDSC(device="cpu", compat_cache=mode, **modes, **KW)
    model.load_state_dict(flax_to_state_dict(variables, KW["num_layers"]),
                          strict=True)
    trainer = Trainer(model, TrainConfig(), [], [], steps_per_epoch=1)
    out = []
    with mock.patch.object(port_pointdsc, "build_compat_cache",
                           _jax_int8_cache if mode == "int8"
                           else port_pointdsc.build_compat_cache):
        for batch in BATCHES:
            metrics = trainer.train_step(batch, epoch=1)
            grads = {n: p.grad.clone() for n, p in model.named_parameters()}
            state = {k: v.clone() for k, v in model.state_dict().items()}
            out.append((metrics, state, grads))
    assert torch.get_num_threads() == THREADS, "steps ran at another count"
    return out, trainer


def run_steps(mode, variables=None, modes=FUSED):
    """Both packages' steps in ``mode`` (the model's other modes, the
    same on both sides, from ``modes``), from ``variables`` (gmf_tpu's
    init, unperturbed; drawn here when None): (mode, initial variables,
    JAX steps, port steps, port trainer)."""
    if variables is None:
        variables = _initial_variables()
    port, trainer = _port_steps(mode, variables, modes)
    return mode, variables, _jax_steps(mode, variables, modes), port, trainer


def _as_state(variables_or_grads, stats):
    return flax_to_state_dict({"params": variables_or_grads,
                               "batch_stats": stats}, KW["num_layers"])


def check_metrics(steps):
    """Loss and metrics of both applied steps; the classification metrics
    count thresholded logits, so they are compared within one flipped
    label of the 160 valid ones."""
    _, _, ref, got, _ = steps
    for i in (0, 2):
        r, g = ref[i][0], got[i][0]
        assert set(r) == set(g)
        for key in ("loss", "class_loss", "sm_loss", "trans_loss"):
            np.testing.assert_allclose(g[key], r[key], rtol=1e-4,
                                       err_msg=key)
        for key in ("re", "te"):
            np.testing.assert_allclose(g[key], r[key], atol=1e-2,
                                       err_msg=key)
        for key in ("precision", "recall", "f1"):
            np.testing.assert_allclose(g[key], r[key], atol=0.02,
                                       err_msg=key)
        assert g["reg_recall"] == r["reg_recall"]
        assert g["skipped_step"] == r["skipped_step"] == 0.0


def check_gradients(steps):
    _, variables, ref, got, _ = steps
    want = _as_state(ref[0][3], variables["batch_stats"])
    have = got[0][2]
    assert set(have) <= set(want)
    scale = max(np.abs(want[k].numpy()).max() for k in have)
    for name, g in have.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(),
                                   atol=2e-3 * scale + 1e-6, err_msg=name)


def check_nan_batch_skipped(steps):
    """The NaN keypoint makes every gradient non-finite on both sides: the
    step is skipped, nothing but the batch statistics changes, and the
    learning-rate schedule does not count it."""
    _, _, ref, got, trainer = steps
    assert ref[1][0]["skipped_step"] == got[1][0]["skipped_step"] == 1.0
    for a, b in zip(jax.tree_util.tree_leaves(ref[1][1]),
                    jax.tree_util.tree_leaves(ref[0][1])):
        assert np.array_equal(a, b)
    params = {n for n, _ in trainer.model.named_parameters()}
    for k in params:
        assert torch.equal(got[1][1][k], got[0][1][k]), k
    assert trainer.applied_steps == 2
    assert all(s["step"].item() == 2 for s in trainer.optimizer.state.values())


def check_params_and_stats(steps):
    """After each applied step. Adam's first step moves a parameter by
    lr * g / (|g| + eps), so +-lr for any gradient well above eps, whatever
    its size: where the gradient is rounding noise on both sides (a bias
    just before a batch norm, whose true gradient is 0) the two may step
    opposite ways, up to 2 lr apart after one step and 4 lr after two.
    Parameters whose first gradient exceeds the gradient bound, so that
    its sign is the same on both sides, step the same way: after one step
    within 1e-6 (measured 4e-9); after two, whose update is a ratio of
    Adam's moments that the second gradient's own bound can move where
    that gradient is small, within 0.25 lr (measured 0.007 lr). Batch
    statistics: 1e-4 of each statistic's scale after one step, the
    forward's bound; 1e-3 after the second, whose forward ran on
    parameters already apart by the bounds above. A
    statistic the NaN batch made NaN is NaN on both sides, as the
    reference keeps the batch statistics of a skipped step."""
    _, variables, ref, got, trainer = steps
    lr = TrainConfig().lr
    g0 = _as_state(ref[0][3], variables["batch_stats"])
    gscale = max(np.abs(v.numpy()).max() for k, v in g0.items()
                 if k in got[0][2])
    params = dict(trainer.model.named_parameters())
    for i, slack, tol, stats_tol in (
            (0, 2 * lr, 1e-6, 1e-4),
            (2, 4 * lr, 0.25 * lr, 1e-3)):
        want = _as_state(ref[i][1], ref[i][2])
        have = got[i][1]
        for k, v in have.items():
            if k.endswith("num_batches_tracked"):
                continue
            r, x = want[k].numpy(), v.numpy()
            if k in params:
                noisy = np.abs(g0[k].numpy()) < 2e-3 * gscale
                atol = np.where(noisy, slack, tol)
                assert (np.abs(x - r) <= atol).all(), (i, k)
            else:
                np.testing.assert_allclose(
                    x, r, atol=stats_tol * max(1.0, np.abs(r).max()),
                    err_msg=f"step {i}: {k}")
