"""The port's training losses vs gmf_tpu.train.losses, and its Trainer,
checkpoints and command line on the CPU at a tiny size."""

import copy
import runpy
import subprocess
import sys
from pathlib import Path
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gmf_tpu.train import losses as jlosses
from gmf_tpu_torch.data.collate import min_clip_collate
from gmf_tpu_torch.data.synthetic import (SyntheticCorrespondenceLoader,
                                          make_correspondence_problem)
from gmf_tpu_torch.models import PointDSC
from gmf_tpu_torch.ops import fused_attention
from gmf_tpu_torch.train import losses
from gmf_tpu_torch.train.trainer import TrainConfig, Trainer
from gmf_tpu_torch.utils.checkpoint import load_checkpoint

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]


def _loss_inputs(seed, masked):
    rng = np.random.RandomState(seed)
    B, N = 2, 60
    prob = make_correspondence_problem(rng, num_corr=N, batch=B,
                                       image_hw=(8, 8))
    f = rng.randn(B, N, 16).astype(np.float32)
    f /= np.linalg.norm(f, axis=-1, keepdims=True)
    M = np.clip(f @ f.transpose(0, 2, 1), 0, 1) * (1 - np.eye(N))
    # a few degrees off the truth: arccos is ill-conditioned at 0
    trans = prob["gt_trans"].copy()
    for b in range(B):
        a = 0.05 * (b + 1)
        Rz = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                       [0, 0, 1]], np.float32)
        trans[b, :3, :3] = Rz @ trans[b, :3, :3]
    trans[:, :3, 3] += 0.05 * rng.randn(B, 3)
    mask = None
    if masked:
        mask = np.ones((B, N), np.float32)
        mask[0, 45:] = 0.0
    return dict(logits=rng.randn(B, N).astype(np.float32), M=M.astype(
        np.float32), trans=trans, mask=mask, **prob)


@pytest.mark.parametrize("masked", [False, True])
def test_losses_match_jax(masked):
    """Every output of the three losses, with and without a mask, to f32
    rounding (1e-5 relative)."""
    x = _loss_inputs(3, masked)
    m_j = None if x["mask"] is None else jnp.asarray(x["mask"])
    m_t = None if x["mask"] is None else torch.tensor(x["mask"])
    pairs = [
        (jlosses.classification_loss(jnp.asarray(x["logits"]),
                                     jnp.asarray(x["labels"]), mask=m_j),
         losses.classification_loss(torch.tensor(x["logits"]),
                                    torch.tensor(x["labels"]), mask=m_t)),
        (jlosses.transformation_loss(
            jnp.asarray(x["trans"]), jnp.asarray(x["gt_trans"]),
            jnp.asarray(x["src_keypts"]), jnp.asarray(x["tgt_keypts"]),
            jnp.asarray(x["logits"]), mask=m_j),
         losses.transformation_loss(
            torch.tensor(x["trans"]), torch.tensor(x["gt_trans"]),
            torch.tensor(x["src_keypts"]), torch.tensor(x["tgt_keypts"]),
            torch.tensor(x["logits"]), mask=m_t)),
        ({"sm": jlosses.spectral_matching_loss(
            jnp.asarray(x["M"]), jnp.asarray(x["labels"]), mask=m_j)},
         {"sm": losses.spectral_matching_loss(
            torch.tensor(x["M"]), torch.tensor(x["labels"]), mask=m_t)}),
    ]
    for ref, got in pairs:
        assert set(ref) == set(got)
        for k in ref:
            np.testing.assert_allclose(float(got[k]), float(ref[k]),
                                       rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("mode", ["unbalanced", "weighted"])
def test_unbalanced_and_weighted_losses_match_jax(mode, masked):
    """classification_loss(balanced=False), its per-entry ``weight`` and
    spectral_matching_loss(balanced=False), to f32 rounding (1e-5
    relative)."""
    x = _loss_inputs(3, masked)
    m_j = None if x["mask"] is None else jnp.asarray(x["mask"])
    m_t = None if x["mask"] is None else torch.tensor(x["mask"])
    w = np.random.RandomState(7).rand(*x["logits"].shape).astype(np.float32)
    kw_j = dict(balanced=False)
    kw_t = dict(balanced=False)
    if mode == "weighted":
        kw_j["weight"], kw_t["weight"] = jnp.asarray(w), torch.tensor(w)
    ref = jlosses.classification_loss(jnp.asarray(x["logits"]),
                                      jnp.asarray(x["labels"]), mask=m_j,
                                      **kw_j)
    got = losses.classification_loss(torch.tensor(x["logits"]),
                                     torch.tensor(x["labels"]), mask=m_t,
                                     **kw_t)
    ref["sm"] = jlosses.spectral_matching_loss(
        jnp.asarray(x["M"]), jnp.asarray(x["labels"]), balanced=False,
        mask=m_j)
    got["sm"] = losses.spectral_matching_loss(
        torch.tensor(x["M"]), torch.tensor(x["labels"]), balanced=False,
        mask=m_t)
    if mode == "weighted":  # the weights reach the loss
        balanced = losses.classification_loss(torch.tensor(x["logits"]),
                                              torch.tensor(x["labels"]),
                                              mask=m_t)["loss"]
        assert abs(float(got["loss"]) - float(balanced)) > 1e-3
    assert set(ref) == set(got)
    for k in ref:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_min_clip_collate_matches_jax():
    from gmf_tpu.data.collate import min_clip_collate as jax_collate

    rng = np.random.RandomState(0)
    samples = []
    for n in (50, 37, 44):
        p = make_correspondence_problem(rng, num_corr=n, image_hw=(4, 4))
        samples.append({k: v[0] for k, v in p.items()})
    got = min_clip_collate(samples, np.random.RandomState(9))
    ref = jax_collate(samples, np.random.RandomState(9))
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])
    assert got["corr_pos"].shape == (3, 37, 6)


def test_synthetic_loader_matches_jax():
    from gmf_tpu.data.synthetic import SyntheticCorrespondenceLoader as J

    kw = dict(batch_size=2, num_corr=40, steps_per_epoch=2, seed=4)
    for got, ref in zip(SyntheticCorrespondenceLoader(**kw), J(**kw)):
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k])


def test_trainer_logs_to_tboard_dir(tmp_path):
    """Trainer(tboard_dir=) writes gmf_tpu's metrics log: the same rows
    (prefix, step and every metric) that gmf_tpu's MetricsLogger writes
    for the same history, "Val" 0, "Train" 1, "Val" 1; without a
    directory nothing is written."""
    import json

    from gmf_tpu.utils.logging_utils import MetricsLogger as JaxLogger

    model = PointDSC(num_layers=1, num_channels=16, k=10, device="cpu")
    loader = SyntheticCorrespondenceLoader(batch_size=2, num_corr=60,
                                           steps_per_epoch=1,
                                           image_hw=(16, 16))
    cfg = TrainConfig(max_epoch=1, save_dir=str(tmp_path / "snap"))
    history = Trainer(model, cfg, loader, loader,
                      tboard_dir=str(tmp_path / "tb")).train(snapshot=False)
    ref = JaxLogger(str(tmp_path / "ref"), use_tensorboard=False)
    for kind, step, res in history:
        ref.log(res, step, "Val" if kind == "eval" else "Train")
    ref.close()

    def rows(d):
        with open(tmp_path / d / "metrics.jsonl") as f:
            return [{k: v for k, v in json.loads(line).items()
                     if k != "time"} for line in f]

    got = rows("tb")
    assert [(r["prefix"], r["step"]) for r in got] == [
        ("Val", 0), ("Train", 1), ("Val", 1)]
    assert got == rows("ref")
    assert not (tmp_path / "snap").exists()


def test_trainer_snapshots_and_load(tmp_path):
    """Trainer.train at --tiny size, 1 epoch of 2 steps: eval at epoch 0
    and 1, every step applied, model_best and the recall-stamped snapshot
    written with the model's settings, and load restores the state."""
    model = PointDSC(num_layers=2, num_channels=32, k=10, device="cpu")
    loader = SyntheticCorrespondenceLoader(batch_size=2, num_corr=80,
                                           steps_per_epoch=2,
                                           image_hw=(16, 16))
    cfg = TrainConfig(max_epoch=1, save_dir=str(tmp_path))
    trainer = Trainer(model, cfg, loader, loader)
    history = trainer.train()
    assert [h[:2] for h in history] == [("eval", 0), ("train", 1),
                                        ("eval", 1)]
    assert history[1][2]["skipped_step"] == 0.0
    assert trainer.applied_steps == 2
    recall = history[2][2]["reg_recall"]
    stamped = tmp_path / f"model_1_recall_{recall:.2f}"
    for d in (tmp_path / "model_best", stamped):
        assert (d / "state.pt").exists() and (d / "config.json").exists()
    state, config = load_checkpoint(str(tmp_path / "model_best"))
    assert config["model"]["num_layers"] == 2 and config["lr"] == cfg.lr
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
    trainer.load(str(tmp_path / "model_best"))
    for k, v in model.state_dict().items():
        assert torch.equal(v, saved[k]), k
        assert torch.equal(v, state[k]), k


def test_cli_tiny_on_cpu(tmp_path):
    r = subprocess.run(
        [sys.executable, "-m", "gmf_tpu_torch.train.train_pointdsc",
         "--dataset", "synthetic", "--tiny", "--cpu", "--max-epoch", "1",
         "--steps-per-epoch", "2", "--save-dir", str(tmp_path)],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "final eval: recall=" in r.stdout
    assert (tmp_path / "config.json").exists()
    assert (tmp_path / "model_best" / "state.pt").exists()
    assert (tmp_path / "src" / "gmf_tpu_torch" / "train" /
            "trainer.py").exists()


def test_cli_refuses_datasets_not_ported():
    """The 3DMatch and KITTI loaders are ported (tests/test_torch_eval.py
    trains on 3DMatch fixtures); what the command line refuses is a
    dataset whose root holds no pairs, by name, instead of training
    zero steps."""
    r = subprocess.run(
        [sys.executable, "-m", "gmf_tpu_torch.train.train_pointdsc",
         "--dataset", "3DMatch", "--cpu"], cwd=ROOT, capture_output=True,
        text=True, timeout=120)
    assert r.returncode != 0 and "--dataset 3DMatch: no train pairs" in \
        r.stderr


FAULTS = runpy.run_path(str(ROOT / "scripts" / "check_train_faults.py"))[
    "FAULTS"]


@pytest.fixture(scope="module")
def step_check():
    """chip_smoke.py's f32 train-step check at a tiny size on the CPU: its
    functions, a model, a batch and the model's CPU reference steps."""
    smoke = runpy.run_path(str(ROOT / "chip_smoke.py"), run_name="chip_smoke")
    model = PointDSC(num_layers=2, num_channels=32, k=10, device="cpu",
                     compat_cache="f32", seed=0)
    batch = next(iter(SyntheticCorrespondenceLoader(
        batch_size=2, num_corr=150, steps_per_epoch=1, image_hw=(24, 32),
        seed=0)))
    return (smoke, model, batch,
            smoke["cpu_reference_steps"](model, batch, "f32"))


@pytest.mark.parametrize("case", list(FAULTS))
def test_step_check_catches_backward_faults(step_check, case):
    """compare_train_step passes the plain backward and fails each fault
    that scripts/check_train_faults.py plants on the card; the parameters
    are Adam's update of the step's own gradient either way."""
    smoke, model, batch, cpu_runs = step_check
    bwd = fused_attention.compat_flash_attention_bwd
    fault = FAULTS[case]

    def planted(*args, **kwargs):
        return fault(*bwd(*args, **kwargs))

    with mock.patch.object(fused_attention, "compat_flash_attention_bwd",
                           bwd if fault is None else planted):
        out = smoke["compare_train_step"](copy.deepcopy(model), batch,
                                          cpu_runs)
    assert out["ok"] == (fault is None), out
    assert out["adam_update_max_err"] <= 1e-6
    if fault is None:
        assert out["leaf_err_over_tol_max"] <= 1.0
