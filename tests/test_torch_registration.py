"""The port's registrar stack vs gmf_tpu's: kNN, correspondence building,
the byte-budgeted LRU, the raw-descriptor registrar with and without its
fragment cache, and model loading.

gmf_tpu runs on the CPU (its dense PointDSC path, whose "auto" modes
resolve to the exact kNN and dense scoring there); the port runs the same
modes by name. Registration results are held to tests/test_fused_model.py's
bounds (final_trans atol 1e-3, labels agreement >= 0.99); what both sides
compute with the same operations (indices, masks, labels, matched rows)
must be equal.
"""

import importlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_lru
from gmf_tpu.data.correspondence import (
    build_correspondences as jax_build_correspondences,
    match_descriptors_device as jax_match)
from gmf_tpu.eval.registration import DeviceFragmentCache as JaxFragmentCache
from gmf_tpu.eval.registration import PointDSCRegistrar as JaxRegistrar
from gmf_tpu.geometry.knn import knn as jax_knn
from gmf_tpu.geometry.knn import mutual_nearest_mask as jax_mutual
from gmf_tpu.geometry.knn import nearest_neighbor as jax_nearest_neighbor
from gmf_tpu.geometry.knn import pdist as jax_pdist
from gmf_tpu.models import PointDSC as JaxPointDSC
from gmf_tpu.utils.model_io import load_pointdsc as jax_load_pointdsc
from gmf_tpu_torch.data.correspondence import (build_correspondences,
                                               match_descriptors_device)
from gmf_tpu_torch.eval.registration import (DeviceFragmentCache,
                                             PointDSCRegistrar)
from gmf_tpu_torch.models import PointDSC
from gmf_tpu_torch.train.trainer import TrainConfig, Trainer
from gmf_tpu_torch.utils.bridge import flax_to_state_dict

# the module: the package exports its function knn, as gmf_tpu's does
knn = importlib.import_module("gmf_tpu_torch.geometry.knn")
from gmf_tpu_torch.utils.lru import ByteLRU
from gmf_tpu_torch.utils.model_io import load_pointdsc
from test_torch_model import KW, _problem

torch.set_num_threads(1)

# the modes gmf_tpu's "auto" resolves to on the CPU, named for the port
DENSE = dict(fused_attention=False, knn_topk="exact", hypo_scoring="dense")
D = 32  # descriptor width (in_dim 70 = 6 + 2 D)
BUCKET = 256


@pytest.fixture(scope="module")
def init():
    """One gmf_tpu init of the tiny model (numpy, perturbed batch-norm
    statistics), the weights of every model here."""
    corr, src, tgt, p_img, q_img, _ = _problem()
    v = jax.jit(JaxPointDSC(**KW).init)(jax.random.PRNGKey(0), *map(
        jnp.asarray, (corr, src, tgt, p_img, q_img)))
    v = jax.tree_util.tree_map(np.asarray, v)
    rng = np.random.RandomState(3)
    v["batch_stats"] = jax.tree_util.tree_map_with_path(
        lambda p, a: (0.5 + rng.rand(*a.shape) if p[-1].key == "var"
                      else 0.1 * rng.randn(*a.shape)).astype(np.float32),
        v["batch_stats"])
    return v


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def _rot(a, b):
    ca, sa, cb, sb = np.cos(a), np.sin(a), np.cos(b), np.sin(b)
    return (np.array([[ca, -sa, 0], [sa, ca, 0], [0, 0, 1]])
            @ np.array([[cb, 0, sb], [0, 1, 0], [-sb, 0, cb]]))


def _fragments(seed=0, sizes=(180, 170, 160), scene=260):
    """Fragments of one scene: keypoints in the fragment's own frame
    (world = P x), unit descriptors of the scene point with noise, an
    image each, and the pose P."""
    rng = np.random.RandomState(seed)
    world = rng.rand(scene, 3) * 2.0
    desc = rng.randn(scene, D)
    frags = []
    for f, n in enumerate(sizes):
        idx = rng.choice(scene, n, replace=False)
        P = np.eye(4)
        P[:3, :3] = _rot(0.3 * f + 0.1, 0.2 * f)
        P[:3, 3] = rng.rand(3)
        pts = (world[idx] - P[:3, 3]) @ P[:3, :3]
        pts += 0.005 * rng.randn(n, 3)
        frags.append(dict(
            keypts=pts.astype(np.float32),
            desc=_unit(desc[idx] + 0.3 * rng.randn(n, D)),
            image=rng.rand(16, 16, 3).astype(np.float32), pose=P))
    return frags


def _raw_pairs(frags, pairs):
    """Raw-descriptor samples (fresh dicts: a fetch rewrites them)."""
    out = []
    for i, j in pairs:
        a, b = frags[i], frags[j]
        gt = np.linalg.inv(b["pose"]) @ a["pose"]
        out.append(dict(
            src_keypts=a["keypts"].copy(), tgt_keypts=b["keypts"].copy(),
            src_desc=a["desc"], tgt_desc=b["desc"], p_image=a["image"],
            q_image=b["image"], gt_trans=gt.astype(np.float32),
            src_key=i, tgt_key=j))
    return out


# -- kNN ------------------------------------------------------------------

@pytest.mark.parametrize("case", ["knn", "knn_self_mask", "knn_squared",
                                  "nearest_neighbor", "mutual", "pdist"])
def test_knn_matches_jax(case):
    rng = np.random.RandomState(5)
    x = _unit(rng.randn(2, 90, 16))
    mask = np.ones((2, 90), np.float32)
    mask[1, 70:] = 0.0
    t = torch.tensor
    if case == "knn":
        got, ref = knn.knn(t(x), 7), jax_knn(jnp.asarray(x), 7)
    elif case == "knn_self_mask":
        got = knn.knn(t(x), 7, ignore_self=True, mask=t(mask))
        ref = jax_knn(jnp.asarray(x), 7, ignore_self=True,
                       mask=jnp.asarray(mask))
        assert (got.numpy()[1] < 70).all()
    elif case == "knn_squared":
        y = x * rng.rand(2, 90, 1).astype(np.float32) * 3
        got = knn.knn(t(y), 5, normalized=False)
        ref = jax_knn(jnp.asarray(y), 5, normalized=False)
    elif case == "nearest_neighbor":  # three chunks, the last partial
        a, b = x[0], _unit(rng.randn(120, 16))
        got_i, got_d = knn.nearest_neighbor(t(a), t(b), chunk=32)
        ref_i, ref_d = jax_nearest_neighbor(jnp.asarray(a), jnp.asarray(b),
                                             chunk=32)
        np.testing.assert_allclose(got_d.numpy(), np.asarray(ref_d),
                                   atol=1e-5)
        got, ref = got_i, ref_i
        assert got.dtype == torch.int32
    elif case == "mutual":
        a, b = x[0], x[1] + 0.1 * rng.randn(90, 16).astype(np.float32)
        got_m, got = knn.mutual_nearest_mask(t(a), t(b), chunk=64)
        ref_m, ref = jax_mutual(jnp.asarray(a), jnp.asarray(b),
                                              chunk=64)
        np.testing.assert_array_equal(got_m.numpy(), np.asarray(ref_m))
        assert 0 < got_m.sum() < 90
    else:
        for kind in ("SquareL2", "L2"):
            np.testing.assert_allclose(
                knn.pdist(t(x), t(x[::-1].copy()), kind).numpy(),
                np.asarray(jax_pdist(jnp.asarray(x),
                                      jnp.asarray(x[::-1].copy()), kind)),
                atol=1e-5)
        return
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# -- correspondences ------------------------------------------------------

@pytest.mark.parametrize("use_mutual,in_dim", [(True, 6), (False, 6),
                                               (True, 3), (True, 9),
                                               (True, 70)])
def test_build_correspondences_matches_jax(use_mutual, in_dim):
    frags = _fragments()
    s, = _raw_pairs(frags, [(0, 1)])
    args = (s["src_keypts"], s["tgt_keypts"], s["src_desc"], s["tgt_desc"],
            s["gt_trans"], 0.10)
    got = build_correspondences(*args, use_mutual=use_mutual, in_dim=in_dim)
    ref = jax_build_correspondences(*args, use_mutual=use_mutual,
                                    in_dim=in_dim)
    assert set(got) == set(ref)
    assert 0 < ref["labels"].sum() < len(ref["labels"])
    for key in ref:
        assert got[key].dtype == ref[key].dtype, key
        np.testing.assert_allclose(got[key], ref[key], atol=1e-6,
                                   err_msg=key)
    np.testing.assert_array_equal(got["labels"], ref["labels"])
    # fewer than 10 matches: None on both sides
    few = [a[:8] for a in args[:4]]
    assert build_correspondences(*few, s["gt_trans"], 0.10) is None
    assert jax_build_correspondences(*few, s["gt_trans"], 0.10) is None


def _padded_batch(samples, ns, nt):
    def pad(a, n):
        out = np.zeros((n,) + a.shape[1:], np.float32)
        out[: len(a)] = a
        return out

    arrays = dict(
        src_keypts=np.stack([pad(s["src_keypts"], ns) for s in samples]),
        tgt_keypts=np.stack([pad(s["tgt_keypts"], nt) for s in samples]),
        src_desc=np.stack([pad(s["src_desc"], ns) for s in samples]),
        tgt_desc=np.stack([pad(s["tgt_desc"], nt) for s in samples]),
        gt_trans=np.stack([s["gt_trans"] for s in samples]),
        mask_s=np.stack([(np.arange(ns) < len(s["src_keypts"]))
                         .astype(np.float32) for s in samples]),
        mask_t=np.stack([(np.arange(nt) < len(s["tgt_keypts"]))
                         .astype(np.float32) for s in samples]))
    return arrays


@pytest.mark.parametrize("case", ["in_dim3", "in_dim6", "in_dim9",
                                  "in_dim70", "few_mutual", "no_mutual"])
def test_match_descriptors_device_matches_jax(case):
    frags = _fragments()
    samples = _raw_pairs(frags, [(0, 1), (2, 1)])
    in_dim = int(case[6:]) if case.startswith("in_dim") else 6
    use_mutual = case != "no_mutual"
    if case == "few_mutual":
        # every source descriptor near one direction: they all match one
        # target, so pair 0 has fewer than 10 mutual matches
        rng = np.random.RandomState(1)
        s = samples[0]
        s["src_desc"] = _unit(s["tgt_desc"][3] + 0.01 * rng.randn(
            len(s["src_desc"]), D))
    b = _padded_batch(samples, 200, 190)
    order = ("src_keypts", "tgt_keypts", "src_desc", "tgt_desc", "gt_trans")
    got = match_descriptors_device(
        *(torch.tensor(b[k]) for k in order), 0.10, torch.tensor(b["mask_s"]),
        torch.tensor(b["mask_t"]), use_mutual=use_mutual, in_dim=in_dim)
    ref = jax.vmap(lambda a, c, d, e, g, ms, mt: jax_match(
        a, c, d, e, g, 0.10, ms, mt, use_mutual=use_mutual, in_dim=in_dim))(
        *(jnp.asarray(b[k]) for k in order + ("mask_s", "mask_t")))
    assert set(got) == set(ref)
    for key in ("src_idx", "corr_mask", "labels"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]),
                                      err_msg=key)
    for key in ("corr_pos", "src_keypts", "tgt_keypts"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]),
                                   atol=1e-6, err_msg=key)
    assert got["src_idx"].dtype == torch.int32
    assert got["corr_pos"].shape == (2, 200, in_dim)
    kept = got["corr_mask"].sum(-1).numpy()
    if case == "few_mutual":  # the fallback: every real source row
        assert kept[0] == len(samples[0]["src_keypts"])
    elif use_mutual:
        assert 10 <= kept[1] < len(samples[1]["src_keypts"])
    # padding rows are masked and zero
    assert (got["corr_mask"][:, 180:].numpy() == 0).all()
    assert (got["corr_pos"][0, 180:].numpy() == 0).all()


# -- the LRU --------------------------------------------------------------

@pytest.mark.parametrize("case", [
    test_lru.test_hit_miss_and_eviction,
    test_lru.test_keeps_one_entry_over_budget,
    test_lru.test_disabled_budget_builds_every_time,
    test_lru.test_reset,
    test_lru.test_concurrent_builders_converge_to_first_insert,
    test_lru.test_array_entries_byte_accounting,
], ids=lambda f: f.__name__[5:])
def test_byte_lru(monkeypatch, case):
    """tests/test_lru.py's cases, run on the port's ByteLRU."""
    monkeypatch.setattr(test_lru, "ByteLRU", ByteLRU)
    case()


# -- the raw-descriptor registrar -----------------------------------------

REQUESTS = ([(0, 1), (1, 2), (0, 2)], [(2, 0), (1, 0), (0, 1)])


def _serve(reg, frags, strip_keys=False):
    """The two requests through dispatch_batch/fetch_batch: per request
    (results, the samples as fetch left them)."""
    out = []
    for pairs in REQUESTS:
        samples = _raw_pairs(frags, pairs)
        if strip_keys:
            for s in samples:
                del s["src_key"], s["tgt_key"]
        handle = reg.dispatch_batch(samples)
        out.append((reg.fetch_batch(handle), samples))
    return out


def test_raw_registrar_matches_jax(init):
    """Raw descriptors, matched on the device in the model's call: the
    port against gmf_tpu's registrar, and the port's fragment cache
    against no cache (equal in every bit) and its hits."""
    v = init
    frags = _fragments()
    jm = JaxPointDSC(**KW)
    ref = _serve(JaxRegistrar(jm, v, buckets=(BUCKET,),
                              frag_cache=JaxFragmentCache()), frags)
    model = PointDSC(device="cpu", **DENSE, **KW)
    model.load_state_dict(flax_to_state_dict(v, KW["num_layers"]),
                          strict=True)
    cache = DeviceFragmentCache()
    got = _serve(PointDSCRegistrar(model, buckets=(BUCKET,),
                                   frag_cache=cache), frags)
    plain = _serve(PointDSCRegistrar(model, buckets=(BUCKET,)), frags,
                   strip_keys=True)
    # three fragments, each padded to one bucket: 3 misses, then hits
    assert cache.misses == 3 and cache.hits == 2 * 2 * 3 - 3
    assert cache.nbytes == sum(
        BUCKET * (3 + D + 1) * 4 + f["image"].nbytes for f in frags)
    for (res_g, smp_g), (res_r, smp_r), (res_p, smp_p) in zip(got, ref,
                                                              plain):
        for (tg, lg), (tr, lr), (tp, lp) in zip(res_g, res_r, res_p):
            np.testing.assert_allclose(tg, np.asarray(tr), atol=1e-3)
            assert lg.shape == np.asarray(lr).shape
            assert (lg == np.asarray(lr)).mean() >= 0.99
            np.testing.assert_array_equal(tg, tp)
            np.testing.assert_array_equal(lg, lp)
        for sg, sr, sp in zip(smp_g, smp_r, smp_p):
            # the matched rows, rebuilt on the host from its own copies
            for key in ("src_keypts", "tgt_keypts", "labels"):
                np.testing.assert_array_equal(sg[key], sr[key], err_msg=key)
                np.testing.assert_array_equal(sg[key], sp[key], err_msg=key)
            assert "src_key" not in sg and "corr_mask" not in sg
            assert 10 <= len(sg["labels"]) and sg["labels"].sum() > 0
    # an empty request and the single-pair call
    reg = PointDSCRegistrar(model, buckets=(BUCKET,))
    assert reg.fetch_batch(reg.dispatch_batch([])) == []
    s, = _raw_pairs(frags, [(0, 1)])
    trans, labels = reg(s)  # one pair: its sums may round apart
    np.testing.assert_allclose(trans, got[0][0][0][0], atol=1e-5)
    assert (labels == got[0][0][0][1]).mean() >= 0.99


def test_registrar_single_pair_and_bucket(init):
    """A pair of precomputed correspondences through ``__call__`` (padded
    with its labels) equals the same pair in a batch; eval_bucket opens a
    bucket above the largest, and raw pairs bucket on both sides."""
    model = PointDSC(device="cpu", **DENSE, **KW)
    model.load_state_dict(flax_to_state_dict(init, KW["num_layers"]),
                          strict=True)
    reg = PointDSCRegistrar(model, buckets=(128, 256))
    corr, src, tgt, p_img, q_img, _ = _problem(N=200, n_valid=(200, 200))
    samples = [dict(corr_pos=corr[b], src_keypts=src[b], tgt_keypts=tgt[b],
                    labels=np.ones(200, np.float32), p_image=p_img[b],
                    q_image=q_img[b]) for b in range(2)]
    trans, labels = reg(samples[1])
    batch = reg.register_batch(samples)
    np.testing.assert_allclose(trans, batch[1][0], atol=1e-5)
    assert labels.shape == (200,)
    assert reg.eval_bucket(samples) == 256
    assert reg.eval_bucket([dict(corr_pos=np.zeros((300, 6)))]) == 4096
    raw = _raw_pairs(_fragments(), [(0, 1)])
    assert reg.eval_bucket(raw) == (256, 256)


# -- model loading --------------------------------------------------------

# the weights of the reference's k=1 Conv1d modules, [out, in, 1] there
CONV1D = re.compile(r"encoder\.layer0|PointCN_layer_\d+\.0|projection_[qkv]"
                    r"|fc_message\.[036]|^classification\.[024]")


def test_load_pointdsc_matches_jax(init, tmp_path):
    """A reference-named torch state_dict (Conv1d weights [out, in, 1]),
    loaded by both packages' load_pointdsc: the same weights, the same
    registration; and the port's checkpoint directory round-trips the
    model's settings."""
    sd = {k: v.clone() for k, v in flax_to_state_dict(
        init, KW["num_layers"]).items()}
    for k in sd:
        if k.endswith(".weight") and CONV1D.search(k[:-len(".weight")]):
            sd[k] = sd[k][..., None]
    sd["encoder.image_encoder.backbone.layer3.0.conv1.weight"] = torch.zeros(
        1)  # a key the port does not read
    path = str(tmp_path / "model_best.pth")
    torch.save({"state_dict": sd}, path)

    jm, jv = jax_load_pointdsc(path, num_layers=2, num_channels=32)
    model = load_pointdsc(path, num_layers=2, num_channels=32, device="cpu",
                          k=jm.k, **DENSE)
    want = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, jv), 2)
    have = model.state_dict()
    assert set(want) <= set(have)
    for k, w in want.items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(have[k].numpy(), w.numpy(),
                                          err_msg=k)
    corr, src, tgt, p_img, q_img, mask = _problem()
    args = (corr, src, tgt, p_img, q_img)
    ref = jax.jit(jm.apply, static_argnames="testing")(
        jv, *map(jnp.asarray, args), testing=True,
        corr_mask=jnp.asarray(mask))
    got = model(*map(torch.tensor, args), testing=True,
                corr_mask=torch.tensor(mask))
    np.testing.assert_allclose(got["final_trans"].numpy(),
                               np.asarray(ref["final_trans"]), atol=1e-3)

    # the port's own checkpoint: the trainer's snapshot, settings included
    model = PointDSC(device="cpu", kabsch_method="svd", knn_topk="values",
                     **{**KW, "num_layers": 2})
    Trainer(model, TrainConfig(), [], []).save(str(tmp_path / "snap"))
    back = load_pointdsc(str(tmp_path / "snap"), device="cpu")
    assert back.config == model.config
    assert (back.kabsch_method, back.knn_topk) == ("svd", "values")
    for k, w in model.state_dict().items():
        assert torch.equal(back.state_dict()[k], w), k
