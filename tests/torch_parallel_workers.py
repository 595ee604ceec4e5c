"""What tests/test_torch_parallel.py runs on every rank of a spawned world.

This module imports torch, numpy and the port only: the children of
``parallel/launch.py::launch`` import it by name, and must not import
JAX. The inputs are made here from seeds with numpy, so that the test
process can rebuild the same ones for gmf_tpu. Each world function runs
every check of its world once and returns plain NumPy results; the tests
compare them with gmf_tpu in the parent.
"""

import numpy as np
import torch

# PointDSC at gmf_tpu's golden-test widths (tests/test_golden.py:47)
KW = dict(num_layers=1, num_channels=16, ratio=0.1, k=10, sigma_d=0.10)
# on the card: the kernels are built for head widths 32 and 128
CARD_KW = dict(KW, num_channels=32)
# the modes gmf_tpu's "auto" resolves to on the CPU, named for the port
DENSE = dict(fused_attention=False, knn_topk="exact", hypo_scoring="dense")
RING_N = 64  # tokens of the ring-function cases (divide by 2 and 4)
BUCKET = 256
D_DESC = 16  # raw samples' descriptor width


# -- inputs -----------------------------------------------------------------

def ring_inputs(masked: bool, N: int = RING_N, D: int = 16):
    rng = np.random.RandomState(11 if masked else 10)
    q = (rng.randn(N, D) * 0.3).astype(np.float32)
    k = (rng.randn(N, D) * 0.3).astype(np.float32)
    v = rng.randn(N, D).astype(np.float32)
    s = (rng.rand(N, 3) * 2).astype(np.float32)
    t = (rng.rand(N, 3) * 2).astype(np.float32)
    mask = ((np.arange(N) < 50) if masked else np.ones(N)).astype(np.float32)
    return q, k, v, s, t, mask


def model_problem(seed=7, B=2, N=BUCKET, n_valid=(BUCKET, 200), hw=16):
    """[corr_pos, src, tgt, p_img, q_img, mask]: rotated clouds, a third
    of the rows outliers, pair 1's tail masked (zeroed)."""
    rng = np.random.RandomState(seed)
    src = (rng.rand(B, N, 3) * 2.5).astype(np.float32)
    tgt = np.empty_like(src)
    for b in range(B):
        ang = 0.3 + 0.2 * b
        R = np.array([[np.cos(ang), -np.sin(ang), 0],
                      [np.sin(ang), np.cos(ang), 0], [0, 0, 1]], np.float32)
        tgt[b] = src[b] @ R.T + np.array([0.2, 0.1, 0.05], np.float32)
        out = rng.choice(N, N // 3, replace=False)
        tgt[b, out] = rng.rand(N // 3, 3) * 2.5
    mask = np.zeros((B, N), np.float32)
    for b, n in enumerate(n_valid):
        mask[b, :n] = 1.0
    src *= mask[..., None]
    tgt *= mask[..., None]
    corr = np.concatenate([src - src.mean(1, keepdims=True),
                           tgt - tgt.mean(1, keepdims=True)], -1)
    corr *= mask[..., None]
    p_img = rng.rand(B, hw, hw, 3).astype(np.float32)
    q_img = rng.rand(B, hw, hw, 3).astype(np.float32)
    return [corr.astype(np.float32), src, tgt, p_img, q_img, mask]


def corr_samples(n=3, seed=21):
    """Precomputed-correspondence samples of 180-256 rows."""
    out = []
    for i in range(n):
        rows = 256 - 37 * i
        corr, src, tgt, p, q, _ = model_problem(seed + i, B=1, N=rows,
                                                n_valid=(rows,))
        out.append(dict(corr_pos=corr[0], src_keypts=src[0],
                        tgt_keypts=tgt[0], p_image=p[0], q_image=q[0],
                        labels=(np.arange(rows) % 3 != 0).astype(
                            np.float32),
                        gt_trans=np.eye(4, dtype=np.float32)))
    return out


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def _rot(a, b):
    ca, sa, cb, sb = np.cos(a), np.sin(a), np.cos(b), np.sin(b)
    return (np.array([[ca, -sa, 0], [sa, ca, 0], [0, 0, 1]])
            @ np.array([[cb, 0, sb], [0, 1, 0], [-sb, 0, cb]]))


def fragments(seed=0, sizes=(180, 170, 160), scene=260):
    """Fragments of one scene in their own frames, unit descriptors of
    the scene points with noise, an image and the pose each."""
    rng = np.random.RandomState(seed)
    world = rng.rand(scene, 3) * 2.0
    desc = rng.randn(scene, D_DESC)
    frags = []
    for f, n in enumerate(sizes):
        idx = rng.choice(scene, n, replace=False)
        P = np.eye(4)
        P[:3, :3] = _rot(0.3 * f + 0.1, 0.2 * f)
        P[:3, 3] = rng.rand(3)
        pts = (world[idx] - P[:3, 3]) @ P[:3, :3] + 0.005 * rng.randn(n, 3)
        frags.append(dict(keypts=pts.astype(np.float32),
                          desc=_unit(desc[idx] + 0.3 * rng.randn(n, D_DESC)),
                          image=rng.rand(16, 16, 3).astype(np.float32),
                          pose=P))
    return frags


RAW_PAIRS = ((0, 1), (1, 2), (0, 2))


def raw_samples(keys: bool):
    """Raw-descriptor samples of RAW_PAIRS (fresh dicts: a fetch rewrites
    them), with fragment keys when ``keys``."""
    frags, out = fragments(), []
    for i, j in RAW_PAIRS:
        a, b = frags[i], frags[j]
        s = dict(src_keypts=a["keypts"].copy(), tgt_keypts=b["keypts"].copy(),
                 src_desc=a["desc"], tgt_desc=b["desc"], p_image=a["image"],
                 q_image=b["image"], gt_trans=(np.linalg.inv(b["pose"])
                                               @ a["pose"]).astype(
                                                   np.float32))
        if keys:
            s.update(src_key=i, tgt_key=j)
        out.append(s)
    return out


# -- on the ranks --------------------------------------------------------------

def _np(x):
    return x.detach().cpu().numpy()


def _model(state, **kw):
    from gmf_tpu_torch.models import PointDSC

    model = PointDSC(device="cpu", **{**KW, **DENSE, **kw})
    model.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()},
                          strict=True)
    return model.eval()


def _ring_function(mesh):
    from gmf_tpu_torch.parallel.ring_attention import ring_compat_attention

    out = {}
    for masked in (False, True):
        q, k, v, s, t, m = (torch.tensor(x) for x in ring_inputs(masked))
        for x in (q, k, v):
            x.requires_grad_(True)
        o = ring_compat_attention(q, k, v, s, t, m, mesh, sigma_d=0.3)
        (o * o).sum().backward()
        out[masked] = dict(out=_np(o), dq=_np(q.grad), dk=_np(k.grad),
                           dv=_np(v.grad))
    return out


def _mesh_facts(mesh, world):
    from gmf_tpu_torch.parallel.mesh import (make_mesh, process_shard,
                                             shard_batch)

    facts = dict(shape=dict(mesh.shape), index=dict(mesh.index),
                 backend=mesh.backend, staging=mesh.staging,
                 process_shard=process_shard(list(range(23))),
                 shard=_np(shard_batch({"a": np.arange(16.0).reshape(8, 2)},
                                       mesh)["a"]))
    if world == 4:
        m22 = make_mesh(n_data=2, n_model=2, device="cpu")
        facts["mesh22"] = dict(shape=dict(m22.shape), index=dict(m22.index),
                               shard=_np(shard_batch(np.arange(8.0), m22)))
        try:
            make_mesh(n_data=8, device="cpu")
            facts["too_big"] = None
        except AssertionError as e:
            facts["too_big"] = str(e)
    return facts


def world4(rank, world, spec):
    """The ring function and the mesh helpers over four CPU ranks."""
    from gmf_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(device="cpu")
    return dict(ring=_ring_function(mesh), mesh=_mesh_facts(mesh, world))


def _ring_model(mesh, state):
    """The ring model (test and train branch) and, on this rank alone,
    the dense model on the same weights: outputs, and the train branch's
    gradients of one scalar."""
    args = [torch.tensor(x) for x in model_problem()]
    mask = args.pop()
    ring = _model(state, ring_mesh=mesh)
    dense = _model(state)
    out = {}
    for name, m in (("ring", ring), ("dense", dense)):
        t = m(*args, testing=True, corr_mask=mask)
        m.zero_grad(set_to_none=True)
        r = m(*args, testing=False, corr_mask=mask)
        (r["confidence"].square().mean() + r["M"].mean()).backward()
        out[name] = dict(
            test={k: _np(t[k]) for k in ("final_trans", "confidence",
                                         "seed_fitness", "final_labels")},
            train={k: _np(r[k]) for k in ("final_trans", "confidence")},
            grads={n: _np(p.grad) for n, p in m.named_parameters()
                   if p.grad is not None})
    return out


def _registrar_cases(mesh, state):
    from gmf_tpu_torch.eval.registration import (DeviceFragmentCache,
                                                 PointDSCRegistrar)

    reg = PointDSCRegistrar(_model(state), mesh=mesh, buckets=(BUCKET,))
    out = dict(corr=[(a, b) for a, b in reg.register_batch(corr_samples())])
    raw = raw_samples(keys=False)
    out["raw"] = [(t, l) for t, l in reg.register_batch(raw)]
    out["raw_rows"] = [(s["src_keypts"], s["tgt_keypts"], s["labels"])
                       for s in raw]
    cache = DeviceFragmentCache()
    creg = PointDSCRegistrar(_model(state), mesh=mesh, buckets=(BUCKET,),
                             frag_cache=cache)
    out["cached"] = [creg.register_batch(raw_samples(keys=True))
                     for _ in range(2)]
    out["cache_hits"] = (cache.hits, cache.misses)
    out["single"] = reg(corr_samples()[0])
    out["shards"] = reg.model.compat_cache_shards
    return out


def _service_case(mesh, state):
    """The service over the sharded registrar against direct
    register_batch calls on the same registrar."""
    from gmf_tpu_torch.eval.registration import PointDSCRegistrar
    from gmf_tpu_torch.eval.serving import RegistrationService

    reg = PointDSCRegistrar(_model(state), mesh=mesh, buckets=(BUCKET,))
    samples = corr_samples(5)
    direct = reg.register_batch(samples[:4]) + reg.register_batch(
        samples[4:])
    svc = RegistrationService(reg, max_batch=4, max_wait_ms=50.0)
    served = None
    if not svc.follower:
        futs = [svc.submit(dict(s)) for s in samples]
        served = [f.result() for f in futs]
    svc.close()
    return dict(direct=direct, served=served, follower=svc.follower)


def _trainer_case(mesh, state, batch):
    """One Trainer step on the global batch over the mesh."""
    from gmf_tpu_torch.train.trainer import TrainConfig, Trainer

    model = _model(state)
    trainer = Trainer(model, TrainConfig(), [], [], steps_per_epoch=1,
                      mesh=mesh)
    metrics = trainer.train_step(batch, epoch=1)
    return dict(metrics=metrics,
                state={k: _np(v) for k, v in model.state_dict().items()},
                shards=trainer.model.compat_cache_shards)


DGR_G = 256  # the tiny DGR trainer's granules


def dgr_pairs(n=3, nan_pair=None):
    from gmf_tpu_torch.configs.presets import DGRTrainConfig
    from gmf_tpu_torch.data.dgr_loader import make_dgr_pair

    rng = np.random.RandomState(7)
    pairs = [make_dgr_pair(rng, n_points=300,
                           voxel_size=DGRTrainConfig().voxel_size,
                           image_hw=(16, 16)) for _ in range(n)]
    if nan_pair is not None:
        pairs[nan_pair]["T_gt"] = np.full((4, 4), np.nan, np.float32)
    return pairs


def dgr_trainer(**cfg_kw):
    from gmf_tpu_torch.configs.presets import DGRTrainConfig
    from gmf_tpu_torch.eval.test_dgr import tiny_nets
    from gmf_tpu_torch.train.dgr_trainer import WeightedProcrustesTrainer

    torch.manual_seed(0)
    fcgf, inlier = tiny_nets()
    return WeightedProcrustesTrainer(
        fcgf, inlier, DGRTrainConfig(**cfg_kw), voxel_cap_granule=DGR_G,
        corr_cap_granule=DGR_G, device="cpu")


def _inlier_params(t):
    return {n: _np(p) for n, p in t.inlier.named_parameters()}


def serial_step_initial(t, pairs):
    """gmf_tpu's serial expectation (tests/test_dgr_dp.py::
    _serial_expected) on the port: every pair's gradient on the
    step-initial statistics at the group's bucket, their mean, one
    update. Returns (per-pair losses, new parameters)."""
    raws = [t._prep_pair_raw(p) for p in pairs]
    cap = max([DGR_G] + [-(-max(len(r["uniq"]), len(r["pred_pairs"]))
                           // DGR_G) * DGR_G for r in raws])
    stats = [b for b in t.inlier.buffers() if b.is_floating_point()]
    initial = [b.clone() for b in stats]
    acc, losses = None, []
    for r in raws:
        with torch.no_grad():
            for b, b0 in zip(stats, initial):
                b.copy_(b0)
        loss, _ = t.pair_loss(t._prep_pair_arrays(r, cap))
        grads = torch.autograd.grad(loss, t.params, allow_unused=True)
        grads = [torch.zeros_like(w) if g is None else g
                 for w, g in zip(t.params, grads)]
        losses.append(float(loss.detach()))
        acc = grads if acc is None else [a + g for a, g in zip(acc, grads)]
    for w, g in zip(t.params, acc):
        w.grad = g / len(raws)
    for group in t.optimizer.param_groups:
        group["lr"] = t.learning_rate()
    t.optimizer.step()
    return losses, _inlier_params(t)


def _dgr_case(mesh):
    from gmf_tpu_torch.parallel.mesh import Mesh

    one = Mesh(1, 1, [0], 0, "cpu", None)  # this rank alone
    out = {}
    t = dgr_trainer(procrustes_loss_weight=0.0)
    out["params0"] = _inlier_params(t)
    out["dp"] = t.train_step_dp(dgr_pairs(), mesh)
    out["dp_params"] = _inlier_params(t)
    out["dp_stats"] = {k: _np(v) for k, v in t.inlier.state_dict().items()
                       if "running" in k}
    t1 = dgr_trainer(procrustes_loss_weight=0.0)
    out["one"] = t1.train_step_dp(dgr_pairs(), one)
    out["one_params"] = _inlier_params(t1)
    out["one_stats"] = {k: _np(v) for k, v in t1.inlier.state_dict().items()
                        if "running" in k}
    out["serial_losses"], out["serial_params"] = serial_step_initial(
        dgr_trainer(procrustes_loss_weight=0.0), dgr_pairs())
    tn = dgr_trainer()
    out["nan"] = tn.train_step_dp(dgr_pairs(4, nan_pair=1), mesh)
    out["nan_finite_losses"], _ = serial_step_initial(
        dgr_trainer(), [p for i, p in enumerate(dgr_pairs(4, nan_pair=1))
                        if i != 1])
    out["nan_params_finite"] = all(
        np.isfinite(v).all() for v in _inlier_params(tn).values())
    return out


def world2(rank, world, spec):
    """Every model-level check over two CPU ranks."""
    from gmf_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(device="cpu")
    state = spec["state"]
    return dict(ring=_ring_function(mesh),
                mesh=_mesh_facts(mesh, world),
                ring_model=_ring_model(mesh, state),
                registrar=_registrar_cases(mesh, state),
                service=_service_case(mesh, state),
                trainer=_trainer_case(mesh, state, spec["batch"]),
                dgr=_dgr_case(mesh))


def card_world(rank, world, spec):
    """On the card (tests/test_torch_cuda.py -k parallel): the ring
    function with its gradient, and the registrar's batched path with the
    attention kernels, f32, over the world's mesh."""
    from gmf_tpu_torch.eval.registration import PointDSCRegistrar
    from gmf_tpu_torch.models import PointDSC
    from gmf_tpu_torch.parallel.mesh import make_mesh
    from gmf_tpu_torch.parallel.ring_attention import ring_compat_attention

    mesh = make_mesh()
    out = dict(backend=mesh.backend, staging=mesh.staging, ring={})
    for masked in (False, True):
        q, k, v, s, t, m = (torch.tensor(x, device=mesh.device)
                            for x in ring_inputs(masked))
        for x in (q, k, v):
            x.requires_grad_(True)
        o = ring_compat_attention(q, k, v, s, t, m, mesh, sigma_d=0.3)
        (o * o).sum().backward()
        out["ring"][masked] = dict(out=_np(o), dq=_np(q.grad),
                                   dk=_np(k.grad), dv=_np(v.grad))
    model = PointDSC(device=mesh.device, **CARD_KW)
    model.load_state_dict({k: torch.as_tensor(v) for k, v in
                           spec["state"].items()})
    reg = PointDSCRegistrar(model, mesh=mesh, buckets=(BUCKET,))
    out["corr"] = reg.register_batch(corr_samples())
    return out
