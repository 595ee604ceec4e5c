"""One and two training steps of the port vs gmf_tpu's make_train_step
with compat_cache="int8" (tests/torch_train_parity.py has the setup and
the bounds)."""

import pytest

import torch_train_parity as parity


@pytest.fixture(scope="module")
def steps():
    return parity.run_steps("int8")


@pytest.mark.parametrize("check", [
    parity.check_metrics, parity.check_gradients,
    parity.check_nan_batch_skipped, parity.check_params_and_stats])
def test_train_step_matches_jax(steps, check):
    check(steps)
