"""One and two training steps of the port vs gmf_tpu's make_train_step
with compat_cache="off" (tests/torch_train_parity.py has the setup and
the bounds), and the validation step vs make_eval_step."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_train_parity as parity
from gmf_tpu.models import PointDSC as JaxPointDSC
from gmf_tpu.train.trainer import TrainConfig as JaxTrainConfig
from gmf_tpu.train.trainer import make_eval_step
from gmf_tpu_torch.models import PointDSC
from gmf_tpu_torch.train.trainer import TrainConfig, eval_step, to_device
from gmf_tpu_torch.utils.bridge import flax_to_state_dict


@pytest.fixture(scope="module")
def steps():
    return parity.run_steps("off")


@pytest.mark.parametrize("check", [
    parity.check_metrics, parity.check_gradients,
    parity.check_nan_batch_skipped, parity.check_params_and_stats])
def test_train_step_matches_jax(steps, check):
    check(steps)


def test_eval_step_matches_jax():
    """The validation step (train branch, running batch-norm statistics,
    no update) against gmf_tpu's make_eval_step, on weights whose running
    statistics are not the initial 0 and 1: the losses to 1e-4, the
    registration angles and distances to 1e-2, the classification
    metrics within one flipped label."""
    v = parity._initial_variables()
    rng = np.random.RandomState(3)
    v["batch_stats"] = jax.tree_util.tree_map_with_path(
        lambda p, a: (0.5 + rng.rand(*a.shape) if p[-1].key == "var"
                      else 0.1 * rng.randn(*a.shape)).astype(np.float32),
        v["batch_stats"])
    batch = parity.BATCHES[0]
    jm = JaxPointDSC(fused_attention=True, knn_topk="fused",
                     hypo_scoring="fused", compat_cache="off", **parity.KW)
    ref = jax.jit(make_eval_step(jm, JaxTrainConfig()))(
        v["params"], v["batch_stats"],
        {k: jnp.asarray(x) for k, x in batch.items()})
    model = PointDSC(device="cpu", compat_cache="off", **parity.KW)
    model.load_state_dict(flax_to_state_dict(v, parity.KW["num_layers"]),
                          strict=True)
    got = eval_step(model, TrainConfig(), to_device(batch, "cpu"))
    assert set(got) == set(ref)
    for key in ("class_loss", "sm_loss", "trans_loss"):
        np.testing.assert_allclose(got[key], float(ref[key]), rtol=1e-4,
                                   err_msg=key)
    for key in ("re", "te"):
        np.testing.assert_allclose(got[key], float(ref[key]), atol=1e-2,
                                   err_msg=key)
    for key in ("precision", "recall", "f1"):
        np.testing.assert_allclose(got[key], float(ref[key]), atol=0.02,
                                   err_msg=key)
    assert got["reg_recall"] == float(ref["reg_recall"])
    assert not torch.is_grad_enabled() or all(
        p.grad is None for p in model.parameters())
