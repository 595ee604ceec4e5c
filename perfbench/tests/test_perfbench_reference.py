"""The plain reference against the port's plain path on the CPU, at a
tiny size, on the same weights and inputs: the encoder from scratch; from
the port's encoder output, the seed stage (confidence, seeds, hypotheses,
winner, labels, refined transform). The tests may import the port; the
reference does not."""

from __future__ import annotations

import json

import pytest
import torch

from perfbench import judge
from perfbench.drivers.eval_batch import padded_batch
from perfbench.reference import pointdsc as ref
from perfbench.tests.tiny import REPO
from perfbench.traffic import generator
from perfbench.weights import make_weights

CASES = {
    "3dmatch": ("pointdsc_gmf_3dmatch", "3dmatch_b64", 300, [200, 300]),
    "kitti": ("pointdsc_gmf_kitti", "kitti_b8", 400, [400, 400]),
}


def _case(name):
    conf, mix_name, bucket, valid = CASES[name]
    cfg = json.loads((REPO / f"perfbench/configs/{conf}.json").read_text())
    cfg["model"].update(num_layers=2, num_channels=32, k=8)
    mix = json.loads((REPO / f"perfbench/traffic/mixes/{mix_name}.json")
                     .read_text())
    mix.update(pairs_per_request=3, pool_requests=1, bucket=bucket,
               valid=valid, image_hw=[24, 32])
    return cfg, mix


@pytest.mark.parametrize("name", sorted(CASES))
def test_reference_follows_the_port(name):
    from gmf_tpu_torch.models import PointDSC

    cfg, mix = _case(name)
    m = cfg["model"]
    W = make_weights(m, 2**31 + 5, "cpu")
    model = PointDSC(**m, **cfg["modes"], device="cpu")
    model.load_state_dict(W, strict=True)
    batch = padded_batch(generator.pool(mix, 11)[0], mix["bucket"], "cpu")
    seen = {}
    hook = model.encoder.register_forward_hook(
        lambda mod, a, out: seen.__setitem__("feats", out))
    with torch.no_grad():
        out = model(batch["corr_pos"], batch["src"], batch["tgt"],
                    batch["p_image"], batch["q_image"], testing=True,
                    corr_mask=batch["mask"])
        hook.remove()
        feats = ref.encode_blocks(W, m, batch, 2)
        valid = batch["mask"][..., None] > 0
        err = torch.where(valid, (seen["feats"] - feats).abs(), 0.0).max()
        assert err <= 1e-5 * feats.abs().max()
        st = ref.seed_stage(W, m, seen["feats"], batch)
    assert torch.equal(st["confidence"], out["confidence"])
    corners, size = judge.box_corners(batch["src"], batch["mask"])
    disp = judge.displacement(out["seed_trans"], st["seed_trans"], corners)
    assert float((disp / size[:, None]).max()) < 1e-4
    assert torch.equal(st["winner"], out["seed_fitness"].argmax(-1))
    assert torch.equal(st["labels"], out["final_labels"])
    assert float(judge.displacement(out["final_trans"], st["final_trans"],
                                    corners).max()) < 1e-5 * float(size.max())
