"""The control, the plain reference computed with TF32 products (the
precision below the configurations' f32) and put in the program's place,
has to come out as not correct: at a tiny size on the CPU (TF32 emulated
by rounding each product's operands), and, on the card, at each cell's
own size on three seeds (``-m cuda``)."""

from __future__ import annotations

import pytest
import torch

from perfbench import harness, limits
from perfbench.tests.tiny import CELL, REPO, tiny_tree

BATCH_CELLS = ["pointdsc_3dmatch_eval_b64", "pointdsc_kitti_eval_b8",
               "pointdsc_3dmatch_service"]


def _fails(readings, cell):
    return any(readings[k] > v for k, v in cell.cell["limits"].items())


@pytest.mark.parametrize("base", BATCH_CELLS)
def test_control_fails_at_a_tiny_size(tmp_path, base):
    cell = harness.Cell(tiny_tree(tmp_path, base), CELL)
    readings = limits.control_readings(cell, 7, torch.device("cpu"))
    assert _fails(readings, cell), readings


def test_training_control_fails_at_a_tiny_size(tmp_path):
    cell = harness.Cell(tiny_tree(tmp_path, "pointdsc_3dmatch_train_b16"),
                        CELL)
    readings = limits.train_readings(cell, 7, torch.device("cpu"))
    assert _fails(readings["control"], cell), readings


@pytest.mark.cuda
@pytest.mark.parametrize("name", BATCH_CELLS)
def test_control_fails_at_the_cells_size(name):
    if not torch.cuda.is_available():
        pytest.skip("needs the card: the cell's own size")
    cell = harness.Cell(REPO, name)
    device = harness.open_device(1)
    for seed in (3000000101, 3000000102, 3000000103):
        readings = limits.control_readings(cell, seed, device)
        assert _fails(readings, cell), (seed, readings)
