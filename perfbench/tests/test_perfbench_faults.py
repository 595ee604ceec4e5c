"""A tiny cell run on the CPU with the timed path broken underneath:
``correct`` has to come out false for each fault the registration cells
can have (an answer altered where it is produced: a transform, a label;
the encoder's output altered), and true without one."""

from __future__ import annotations

import json

import pytest

from perfbench.tests.tiny import REPO, run_tiny, tiny_tree


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_tree(tmp_path_factory.mktemp("faults"))


def test_sound_run_is_correct(root, capsys):
    line = run_tiny(root, capsys)
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0


def _shift_translation(results):
    for trans, _ in results[:1]:
        trans[0, 3] += 0.05
    return results


def _flip_label(results):
    for _, labels in results[:1]:
        labels[0] = 1.0 - labels[0]
    return results


@pytest.mark.parametrize("alter", [_shift_translation, _flip_label],
                         ids=["transform", "label"])
def test_altered_answer_is_caught(root, capsys, monkeypatch, alter):
    from gmf_tpu_torch.eval.registration import PointDSCRegistrar

    fetch = PointDSCRegistrar.fetch_batch
    monkeypatch.setattr(PointDSCRegistrar, "fetch_batch",
                        lambda self, h: alter(fetch(self, h)))
    line = run_tiny(root, capsys)
    assert not line["correct"], line["checks"]


def test_altered_encoder_is_caught(root, capsys, monkeypatch):
    from gmf_tpu_torch.models.pointdsc import NonLocalNet

    forward = NonLocalNet.forward
    monkeypatch.setattr(NonLocalNet, "forward",
                        lambda self, *a, **k: forward(self, *a, **k) * 1.001)
    line = run_tiny(root, capsys)
    assert not line["correct"], line["checks"]
    assert line["checks"]["encoder_err"]["value"] > \
        line["checks"]["encoder_err"]["limit"]


@pytest.fixture(scope="module")
def train_root(tmp_path_factory):
    return tiny_tree(tmp_path_factory.mktemp("train_faults"),
                     "pointdsc_3dmatch_train_b16")


def test_sound_training_run_is_correct(train_root, capsys):
    line = run_tiny(train_root, capsys)
    assert line["correct"], line["checks"]


def test_unchanged_state_is_caught(train_root, capsys, monkeypatch):
    """A step that returns its state unchanged."""
    import torch

    monkeypatch.setattr(torch.optim.Adam, "step",
                        lambda self, closure=None: None)
    line = run_tiny(train_root, capsys)
    assert not line["correct"], line["checks"]


def test_half_batch_is_caught(train_root, capsys, monkeypatch):
    """Half of the batch left out, the mean taken over the rest."""
    from gmf_tpu_torch.train import trainer

    to_device = trainer.to_device
    monkeypatch.setattr(trainer, "to_device", lambda batch, device: {
        k: v[:len(v) // 2] for k, v in to_device(batch, device).items()})
    line = run_tiny(train_root, capsys)
    assert not line["correct"], line["checks"]


@pytest.fixture(scope="module")
def service_root(tmp_path_factory):
    return tiny_tree(tmp_path_factory.mktemp("service_faults"),
                     "pointdsc_3dmatch_service")


def test_service_altered_answer_is_caught(service_root, capsys,
                                          monkeypatch):
    from gmf_tpu_torch.eval.registration import PointDSCRegistrar

    line = run_tiny(service_root, capsys)
    assert line["correct"], line["checks"]
    fetch = PointDSCRegistrar.fetch_batch
    monkeypatch.setattr(PointDSCRegistrar, "fetch_batch",
                        lambda self, h: _shift_translation(fetch(self, h)))
    line = run_tiny(service_root, capsys)
    assert not line["correct"], line["checks"]


def test_pick_one_inlier_below_the_best_is_caught():
    """A scoring fault worth one count: the program picks a hypothesis
    one inlier below the best; the judge starts from the best and the
    answer fails. Picking the best itself passes."""
    import torch

    from perfbench import judge
    from perfbench.reference import pointdsc as ref

    g = torch.Generator().manual_seed(5)
    src = torch.rand(1, 30, 3, generator=g)
    tgt = src.clone()
    tgt[0, 0, 0] += 0.09  # inside 0.1 of the identity, outside of B's
    best = torch.eye(4)
    one_less = torch.eye(4)
    one_less[0, 3] = -0.02
    seed_trans = torch.stack([best, one_less])[None]
    mask = torch.ones(1, 30)
    batch = dict(src=src, tgt=tgt, mask=mask)
    cfg = dict(inlier_threshold=0.1)
    counts = ref.inlier_counts(seed_trans, src, tgt, mask, 0.1)
    assert counts.tolist() == [[30, 29]]
    limits = json.loads((REPO / "perfbench/workloads/"
                         "pointdsc_3dmatch_eval_b64.json").read_text())[
                             "limits"]
    for pick, caught in ((1, True), (0, False)):
        T = seed_trans[:, pick]
        out = dict(seed_trans=seed_trans,
                   seed_fitness=torch.nn.functional.one_hot(
                       torch.tensor([pick]), 2).float(),
                   final_trans=ref.refine(cfg, T, src, tgt, mask),
                   final_labels=ref.labels_of(T, src, tgt, mask, 0.1))
        got = judge.judge_answers(cfg, batch, out)
        failed = any(got[k] > limits[k]
                     for k in ("trans_err_m", "label_mismatch"))
        assert failed == caught, (pick, got)
