"""DGR+GMF registration engine: SE(3) refinement and the whole register().

Counterpart of ``gmf_tpu/models/dgr.py``:
- ``ortho6d_to_rotation``: the 6-D rotation parameterization
  (GMF_DGR_fcgf core/registration.py:16-64).
- ``se3_refine``: ``GlobalRegistration`` (core/registration.py:135-194),
  Adam (optax's ``scale_by_adam``) with the step -lr * gamma**step on the
  HighDimSmoothL1 of warped points, up to 1000 iterations, stopping on
  loss < 1e-7 or 20 cumulative small relative improvements.
- ``DeepGlobalRegistration``: core/deep_global_registration.py:90-410,
  voxelize -> FCGF (or FPFH) features -> 1-NN matching -> the 6-D inlier
  net with GMF images -> sigmoid weights clipped -> weighted Procrustes
  and SE(3) refinement -> the wsum safeguard (RANSAC) -> optional ICP.

Everything runs on the engine's device (the card unless ``device="cpu"``).
As in gmf_tpu, where the device is not the CPU the kernel maps are built
on it (``sparse/device_maps.py``) and the 6-D inlier net runs compacted
convolutions (``sparse/compact.py``); on the CPU the maps come from the
host (``sparse/kernel_map.py``, native builder) and the convolutions run
on dense maps. ``net_dtype="bfloat16"`` builds the default nets as
gmf_tpu's bf16 nets compute with checkpointed f32 weights
(``sparse/resunet.py``'s ``dtype``); geometry and the solve stay f32.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from gmf_tpu_torch.geometry.icp import icp_refine
from gmf_tpu_torch.geometry.kabsch import rigid_transform_3d
from gmf_tpu_torch.geometry.knn import nearest_neighbor
from gmf_tpu_torch.geometry.ransac import (ransac_from_indices,
                                           ransac_sample_indices)
from gmf_tpu_torch.geometry.se3 import integrate_trans
from gmf_tpu_torch.sparse.device_maps import build_pyramid_arrays_device
from gmf_tpu_torch.sparse.kernel_map import (_pad_cap, build_pyramid,
                                             pyramid_map_stats)
from gmf_tpu_torch.sparse.resunet import (FCGFNet, GMFInlierNet,
                                          pyramid_to_arrays)
from gmf_tpu_torch.sparse.voxelize import sparse_quantize
from gmf_tpu_torch.train.losses import high_dim_smooth_l1_loss
from gmf_tpu_torch.utils.device import resolve_device, timed_stage
from gmf_tpu_torch.utils.lru import ByteLRU


def ortho6d_to_rotation(poses):
    """[B, 6] -> [B, 3, 3] rotations by Gram-Schmidt; columns (x, y, z)."""
    x_raw, y_raw = poses[:, 0:3], poses[:, 3:6]
    x = x_raw / torch.clamp(torch.linalg.norm(x_raw, dim=1, keepdim=True),
                            min=1e-8)
    y = y_raw - (x * y_raw).sum(1, keepdim=True) * x
    y = y / torch.clamp(torch.linalg.norm(y, dim=1, keepdim=True), min=1e-8)
    z = torch.linalg.cross(x, y, dim=1)
    return torch.stack([x, y, z], dim=-1)


def se3_refine(points, trans_points, weights, init_trans,
               max_iter: int = 1000, lr: float = 0.1, gamma: float = 0.999,
               break_threshold_ratio: float = 1e-5,
               max_break_count: int = 20, quantization_size: float = 1.0,
               check_every: int = 16):
    """Gradient-based SE(3) refinement (``GlobalRegistration``).

    Optimizes a 6-D rotation and a translation with Adam on the weighted
    HighDimSmoothL1 of warped points, with the reference's stopping rules.
    The stop is decided on the device; the host reads it every
    ``check_every`` iterations, and an iteration after the stop changes
    nothing (every state update is masked by it), so the result equals a
    loop that stopped at once.

    Returns (trans [4, 4], final_loss, iterations), tensors on the points'
    device.
    """
    dt, dev = points.dtype, points.device
    R0, t0 = init_trans[:3, :3].to(dt), init_trans[:3, 3].to(dt)
    params = [torch.cat([R0[:, 0], R0[:, 1]])[None], t0[None]]
    mu = [torch.zeros_like(p) for p in params]
    nu = [torch.zeros_like(p) for p in params]
    b1, b2, eps = 0.9, 0.999, 1e-8
    one = torch.ones((), dtype=dt, device=dev)

    def loss_fn(rot6d, trans):
        R = ortho6d_to_rotation(rot6d)[0]
        warped = points @ R.T + trans[0]
        return high_dim_smooth_l1_loss(warped, trans_points, weights=weights,
                                       quantization_size=quantization_size)

    with torch.no_grad():
        loss_prev = loss_fn(*params)
    brk = torch.zeros((), dtype=torch.int32, device=dev)
    it = torch.zeros((), dtype=torch.int32, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    for step in range(max_iter):
        active = ~done
        leaves = [p.detach().requires_grad_() for p in params]
        with torch.enable_grad():
            loss = loss_fn(*leaves)
            grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            frozen = loss < 1e-7  # the reference breaks before the step
            # optax scale_by_adam, then scale_by_schedule(-lr * gamma**step)
            c1 = one - (b1 * one) ** (step + 1)
            c2 = one - (b2 * one) ** (step + 1)
            scale = -lr * (gamma * one) ** step
            for i, (p, g) in enumerate(zip(params, grads)):
                m = torch.where(active, (1 - b1) * g + b1 * mu[i], mu[i])
                v = torch.where(active, (1 - b2) * g * g + b2 * nu[i], nu[i])
                mu[i], nu[i] = m, v
                stepped = p + (m / c1) / (torch.sqrt(v / c2) + eps) * scale
                params[i] = torch.where(active & ~frozen, stepped, p)
            improved = (torch.abs(loss_prev - loss)
                        < loss_prev * break_threshold_ratio)
            # the reference's break counter is CUMULATIVE: never reset
            brk = torch.where(active & improved, brk + 1, brk)
            loss_prev = torch.where(active, loss, loss_prev)
            it = it + active.to(it.dtype)
            done = done | frozen | (brk >= max_break_count)
        if (step + 1) % check_every == 0 and bool(done):
            break
    with torch.no_grad():
        R = ortho6d_to_rotation(params[0])[0]
        return integrate_trans(R, params[1][0]), loss_prev, it


def inlier_input_feature_dim(feat_type: str, fcgf_dim: int = 32) -> int:
    """Input channels of the inlier net per feature mode (the reference
    sizes the net the same way, core/trainer.py:81,90)."""
    if feat_type == "ones":
        return 1
    if feat_type == "coords":
        return 6
    if feat_type == "feats":
        return 2 * fcgf_dim
    raise ValueError(f"unknown inlier_feature_type {feat_type!r}")


def inlier_input_features(feat_type: str, pts0, pts1, F0, F1, idx0, idx1,
                          device=None):
    """Per-correspondence inlier-net input features [N, C] on ``device``
    (ref core/deep_global_registration.py:236-246): 'ones' = [N, 1] ones;
    'feats' = the two descriptor rows side by side; 'coords' = cos(xyz)
    of the two voxelized points side by side."""
    dev = resolve_device(device)
    i0 = torch.as_tensor(np.asarray(idx0), device=dev).long()
    i1 = torch.as_tensor(np.asarray(idx1), device=dev).long()

    def t(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    if feat_type == "ones":
        return torch.ones(len(i0), 1, dtype=torch.float32, device=dev)
    if feat_type == "feats":
        return torch.cat([t(F0)[i0], t(F1)[i1]], dim=1)
    if feat_type == "coords":
        return torch.cat([torch.cos(t(pts0)[i0]), torch.cos(t(pts1)[i1])],
                         dim=1)
    raise ValueError(f"unknown inlier_feature_type {feat_type!r}")


@dataclasses.dataclass
class DGRConfig:
    """GMF_DGR config defaults (config_3DMatch.py; KITTI deltas in
    brackets)."""

    voxel_size: float = 0.05           # [0.3 KITTI]
    inlier_feature_type: str = "ones"
    clip_weight_thresh: float = 0.05
    use_icp: bool = False
    icp_max_iters: int = 20
    safeguard_ransac_iters: int = 80000
    safeguard_min_weight: float = 200.0
    safeguard_min_frac: float = 0.05
    voxel_cap_granule: int = 4096
    corr_cap_granule: int = 2048
    nn_chunk: int = 2048
    # the frames' size, as gmf_tpu's config records it; the loaders carry
    # the size they resize to (``eval/test_dgr.py`` reads the dataset's)
    image_hw: Tuple[int, int] = (120, 160)
    descriptor: str = "fcgf"   # 'fpfh': GMF_DGR_fpfh's variant (:173-198)
    # the default nets' compute type, "float32" or "bfloat16": bf16 nets
    # keep f32 parameters and run the image encoder, both fusion layers,
    # conv1_tr and final in bf16, the sparse trunk in f32, as gmf_tpu's
    # bf16 nets do with a checkpoint's f32 weights
    net_dtype: str = "float32"
    # kernel maps built on the device (sparse/device_maps.py) or on the
    # host; None = auto, on wherever the engine's device is not the CPU
    # (gmf_tpu's rule: any backend but the CPU)
    device_kernel_maps: Optional[bool] = None
    # the 6-D inlier net on compacted schedules (sparse/compact.py), which
    # need device maps: without them the host maps' dense convolutions
    # run, as in gmf_tpu. None = follow use_device_maps()
    compact_inlier_conv: Optional[bool] = None
    # offsets with at least this share of a map's rows hit stay in the
    # dense tier (compact.plan_tiles); gmf_tpu's value, tuned on its TPU
    compact_dense_frac: float = 0.25

    def use_device_maps(self, device) -> bool:
        if self.device_kernel_maps is not None:
            return self.device_kernel_maps
        return torch.device(device).type != "cpu"

    def use_compact_conv(self, device) -> bool:
        if self.compact_inlier_conv is not None:
            return self.compact_inlier_conv
        return self.use_device_maps(device)

    def check(self) -> None:
        """Raise on a setting that does not exist."""
        if self.net_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unknown net_dtype {self.net_dtype!r}")
        if self.descriptor not in ("fcgf", "fpfh"):
            raise ValueError(f"unknown descriptor {self.descriptor!r}")
        inlier_input_feature_dim(self.inlier_feature_type)


class DeepGlobalRegistration:
    """End-to-end DGR+GMF inference engine on one device.

    Holds the FCGF descriptor net and the 6-D GMF inlier net (state dicts
    of ``sparse/resunet.py``'s nets, e.g. from ``utils/bridge.py`` or
    ``utils/model_io.py::load_dgr``; ``None`` keeps the model's own
    weights) and runs voxelization on the host, the kernel maps on the
    device or the host (``DGRConfig.use_device_maps``), and the nets and
    the solve on the device.

    ``stage_seconds``: when set to a dict, each stage adds its seconds
    there, the device synchronised at its ends (chip_smoke.py's split;
    off by default, as it costs a sync a stage). While it is set,
    ``last_inlier_maps`` keeps the last 6-D pyramid's voxels a level and
    each map's K', M and share of entries that are not the sentinel
    (``kernel_map.pyramid_map_stats``).
    """

    def __init__(self, fcgf_state=None, inlier_state=None,
                 config: Optional[DGRConfig] = None, fcgf_model=None,
                 inlier_model=None, fcgf_dim: int = 32,
                 frag_cache_bytes: int = 0, device=None):
        self.config = config or DGRConfig()
        self.config.check()
        self.device = resolve_device(device)
        self.fcgf_dim = fcgf_dim
        # LRU of prepare_fragment() entries keyed by caller-supplied
        # fragment ids (register(cache_key0=...)): in an eval set every
        # fragment appears in many pairs, and its front half is
        # bit-identical each time. 0 disables.
        self._frag_cache = ByteLRU(frag_cache_bytes) if frag_cache_bytes \
            else None
        # as gmf_tpu, net_dtype sets the default nets' type; nets given
        # keep their own
        nd = getattr(torch, self.config.net_dtype)
        self.fcgf = fcgf_model or FCGFNet(conv1_kernel_size=7, dtype=nd)
        self.inlier = inlier_model or GMFInlierNet(
            in_channels=self.inlier_feature_dim(), dtype=nd)
        for net, state in ((self.fcgf, fcgf_state),
                           (self.inlier, inlier_state)):
            if state is not None:
                net.load_state_dict(state, strict=True)
            net.to(self.device).eval()
        self.stage_seconds: Optional[Dict[str, float]] = None
        self.last_inlier_maps: Optional[Dict] = None

    def _stage(self, name: str):
        return timed_stage(self.stage_seconds, name, self.device)

    def _tensor(self, x, dtype=torch.float32):
        if isinstance(x, torch.Tensor):
            return x.to(self.device, dtype)
        return torch.tensor(np.asarray(x), dtype=dtype, device=self.device)

    def inlier_feature_dim(self) -> int:
        return inlier_input_feature_dim(self.config.inlier_feature_type,
                                        self.fcgf_dim)

    def inlier_feature_generation(self, pts0, pts1, F0, F1, nn01):
        """Per-correspondence inlier-net input features [N, C]."""
        return inlier_input_features(
            self.config.inlier_feature_type, pts0, pts1, F0, F1,
            np.arange(len(nn01)), nn01, device=self.device)

    @staticmethod
    def _solve(uniq_logits, inverse, src, tgt, valid, clip_thresh: float,
               quant_size: float):
        """Per-corr logits -> sigmoid -> clip -> weighted Procrustes ->
        SE(3) refinement, on the device. Padded rows (valid = 0) weigh 0,
        which Procrustes and the refinement ignore exactly. The wsum
        safeguard gate (ref :330) is decided on the host afterwards."""
        w = torch.sigmoid(uniq_logits[inverse]) * valid
        w = torch.where(w < clip_thresh, torch.zeros_like(w), w)
        T0 = rigid_transform_3d(src[None], tgt[None], w[None])[0]
        # register() refines with break_threshold_ratio=1e-4 and
        # quantization_size = 2 * voxel_size (ref :336-343)
        T, _, _ = se3_refine(src, tgt, w, T0, break_threshold_ratio=1e-4,
                             quantization_size=quant_size)
        return T, w.sum(), w

    # -- pipeline stages ---------------------------------------------------

    def preprocess(self, xyz: np.ndarray):
        """Voxelize a cloud (ref :157-185). Returns (coords, sel_idx)."""
        with self._stage("voxelize"):
            return sparse_quantize(xyz, self.config.voxel_size)

    def _pyramid_arrays(self, coords: np.ndarray, net, granule: int,
                        stage: str):
        """The kernel-map pyramid for ``net``'s conv1 as tensors on the
        device, built there or on the host (the same maps; the compacted
        schedules where the config takes them, 6-D only)."""
        cfg = self.config
        stats = ({} if self.stage_seconds is not None and net is self.inlier
                 else None)
        with self._stage(stage):
            if cfg.use_device_maps(self.device):
                arrays = build_pyramid_arrays_device(
                    coords, num_levels=4,
                    conv1_kernel_size=net.conv1_kernel_size, granule=granule,
                    compact_conv=cfg.use_compact_conv(self.device),
                    compact_dense_frac=cfg.compact_dense_frac,
                    device=self.device, stats=stats)
            else:
                pyr = build_pyramid(coords, num_levels=4,
                                    conv1_kernel_size=net.conv1_kernel_size,
                                    granule=granule)
                if stats is not None:
                    stats.update(pyramid_map_stats(pyr))
                arrays = pyramid_to_arrays(pyr, self.device)
        if stats is not None:
            self.last_inlier_maps = stats
        return arrays

    def _fcgf_features_device(self, coords: np.ndarray):
        """FCGF features and the level-0 mask, both ON the device."""
        arrays = self._pyramid_arrays(coords, self.fcgf,
                                      self.config.voxel_cap_granule,
                                      "pyramid_3d")
        cap0 = arrays["mask_0"].shape[0]
        with self._stage("fcgf"), torch.no_grad():
            feats = torch.ones(cap0, 1, device=self.device)
            return self.fcgf(feats, arrays), arrays["mask_0"]

    def descriptor_features(self, coords: np.ndarray, pts=None
                            ) -> np.ndarray:
        """The descriptors of one voxelized cloud that ``register``
        matches: FCGF of ``coords``, or FPFH of ``pts`` (its voxelized
        points) when ``descriptor="fpfh"`` (ref :187-195, :173-198)."""
        if self.config.descriptor == "fpfh":
            return self.fpfh_features(pts).cpu().numpy()
        return self.fcgf_features(coords)

    def fcgf_features(self, coords: np.ndarray) -> np.ndarray:
        """FCGF descriptors of one voxelized cloud (ref :187-195)."""
        out, _ = self._fcgf_features_device(coords)
        return out[:len(coords)].cpu().numpy()

    def fpfh_features(self, pts):
        """FPFH of one cloud's voxelized points on the device (the fpfh
        variant, ref :173-198)."""
        from gmf_tpu_torch.ops.fpfh import compute_fpfh

        vs = self.config.voxel_size
        with self._stage("fpfh"):
            return compute_fpfh(self._tensor(pts), normal_radius=2 * vs,
                                feature_radius=5 * vs)

    def feature_matching(self, F0, F1) -> np.ndarray:
        """Chunked 1-NN in descriptor space (ref :197-209)."""
        with self._stage("nn"):
            idx, _ = nearest_neighbor(self._tensor(F0), self._tensor(F1),
                                      chunk=self.config.nn_chunk)
            return idx.cpu().numpy()

    def _inlier_logits_device(self, corr_coords6d: np.ndarray, p_image,
                              q_image, corr_feats=None):
        """The 6-D inlier net on the unique 6-D coords: (uniq_logits
        [cap] ON the device, inverse [N] host map from corrs to unique
        voxels). corr_feats [N, C] is reduced to the unique voxels by
        FIRST occurrence; None = ones."""
        with self._stage("unique"):
            uniq, first_idx, inverse = sparse_quantize(
                corr_coords6d.astype(np.float64), 1.0, return_index=True,
                return_inverse=True)
        arrays = self._pyramid_arrays(uniq, self.inlier,
                                      self.config.corr_cap_granule,
                                      "pyramid_6d")
        cap0 = arrays["mask_0"].shape[0]
        c = self.inlier_feature_dim()
        with self._stage("inlier_net"), torch.no_grad():
            if corr_feats is None:
                feats = torch.ones(cap0, c, device=self.device)
            else:
                feats = torch.zeros(cap0, c, device=self.device)
                feats[:len(first_idx)] = torch.as_tensor(
                    corr_feats, dtype=torch.float32, device=self.device)[
                        torch.as_tensor(first_idx, device=self.device)]
            logits = self.inlier(feats, arrays,
                                 p_image=self._tensor(p_image),
                                 q_image=self._tensor(q_image))
        return logits[:, 0], inverse

    def inlier_prediction(self, corr_coords6d: np.ndarray, p_image,
                          q_image, corr_feats=None) -> np.ndarray:
        """The 6-D inlier net with image fusion (ref :248-260) as
        ``register`` runs it: corr_coords6d [N, 6] int voxel coords (src
        ++ tgt), corr_feats optional [N, C] inputs; returns the
        per-correspondence logits [N]."""
        uniq_logits, inverse = self._inlier_logits_device(
            corr_coords6d, p_image, q_image, corr_feats=corr_feats)
        return uniq_logits.cpu().numpy()[inverse]

    def safeguard_indices(self, n: int, seed: int = 0) -> torch.Tensor:
        """The safeguard's hypotheses [total, 4]: drawn on the CPU from a
        seeded generator, so every device draws the same ones."""
        gen = torch.Generator().manual_seed(seed)
        return ransac_sample_indices(
            gen, n, self.config.safeguard_ransac_iters, sample_size=4)

    def safeguard_registration(self, src, tgt, seed: int = 0) -> np.ndarray:
        """RANSAC fallback (ref :57-88, 348-396): 80,000 hypotheses of 4
        correspondences (o3d ransac_n=4), inlier distance 2 * voxel_size,
        drawn by ``safeguard_indices``."""
        with self._stage("safeguard"):
            T, _, _ = ransac_from_indices(
                self._tensor(src), self._tensor(tgt),
                self.safeguard_indices(len(src), seed),
                inlier_threshold=2 * self.config.voxel_size)
            return T.cpu().numpy()

    # -- end-to-end ---------------------------------------------------------

    def prepare_fragment(self, xyz: np.ndarray) -> Dict:
        """Per-fragment front half: voxelize + descriptors (left on the
        device). It depends on one cloud only, so an eval set reuses it
        across every pair the fragment appears in."""
        coords, sel = self.preprocess(np.asarray(xyz))
        pts = np.asarray(xyz)[sel]
        if self.config.descriptor == "fcgf":
            F_dev, mask = self._fcgf_features_device(coords)
            return {"coords": coords, "sel": sel, "pts": pts, "F": F_dev,
                    "mask": mask}
        return {"coords": coords, "sel": sel, "pts": pts,
                "F": self.fpfh_features(pts), "mask": None}

    @staticmethod
    def _frag_nbytes(ent: Dict) -> int:
        n = ent["coords"].nbytes + ent["sel"].nbytes + ent["pts"].nbytes
        for key in ("F", "mask"):
            if ent[key] is not None:
                n += ent[key].numel() * ent[key].element_size()
        return n

    @property
    def frag_cache_hits(self) -> int:
        return self._frag_cache.hits if self._frag_cache is not None else 0

    def reset_frag_cache(self) -> None:
        """Drop every cached fragment and zero the hit counter."""
        if self._frag_cache is not None:
            self._frag_cache.reset()

    def seed_fragment(self, xyz: np.ndarray, key) -> None:
        """Prepare one fragment and keep it in the fragment cache under
        ``key`` (an eval's steady state, where an earlier pair already
        cached it)."""
        with torch.no_grad():
            self._fragment_entry(np.asarray(xyz), key)

    def _fragment_entry(self, xyz: np.ndarray, key) -> Dict:
        if key is None or self._frag_cache is None:
            return self.prepare_fragment(xyz)

        def build():
            ent = self.prepare_fragment(xyz)
            for v in ent.values():
                # shared by every later pair that reuses the fragment
                # (register() returns e0['sel'] in 'corres'): read-only
                if isinstance(v, np.ndarray):
                    v.setflags(write=False)
            return ent, self._frag_nbytes(ent)

        return self._frag_cache.get(key, build)

    def register(self, xyz0: np.ndarray, xyz1: np.ndarray, p_image,
                 q_image, cache_key0=None, cache_key1=None) -> Dict:
        """Full DGR+GMF registration (ref :281-410).

        p_image/q_image: [1, H, W, 3] frames. cache_key0/1: optional
        stable fragment ids for the fragment cache (``frag_cache_bytes``);
        the results are bit-identical with or without it.

        Returns dict(trans [4, 4], weights [N], corres (idx0, idx1),
        used_safeguard bool).
        """
        cfg = self.config
        with torch.no_grad():
            e0 = self._fragment_entry(np.asarray(xyz0), cache_key0)
            e1 = self._fragment_entry(np.asarray(xyz1), cache_key1)
            coords0, pts0 = e0["coords"], e0["pts"]
            coords1, pts1 = e1["coords"], e1["pts"]

            if cfg.descriptor == "fcgf":
                # padded rows are zero features: push them to a far
                # distance so that they never win the argmin
                F0, F1, m1 = e0["F"], e1["F"], e1["mask"]
                with self._stage("nn"):
                    F1_masked = torch.where(m1[:, None] > 0, F1,
                                            torch.full_like(F1, 1e6))
                    idx, _ = nearest_neighbor(F0, F1_masked,
                                              chunk=cfg.nn_chunk)
                    nn01 = idx.cpu().numpy()[:len(coords0)]
            else:
                F0, F1 = e0["F"], e1["F"]
                nn01 = self.feature_matching(F0, F1)

            corr6d = np.concatenate([coords0, coords1[nn01]], axis=1)
            corr_feats = (None if cfg.inlier_feature_type == "ones" else
                          self.inlier_feature_generation(pts0, pts1, F0, F1,
                                                         nn01))
            uniq_logits, inverse = self._inlier_logits_device(
                corr6d, p_image, q_image, corr_feats=corr_feats)
            n = len(pts0)
            cap = _pad_cap(n, cfg.corr_cap_granule)
            inv_pad = np.zeros(cap, np.int64)
            inv_pad[:n] = inverse
            src_pad = np.zeros((cap, 3), np.float32)
            src_pad[:n] = pts0
            tgt_pad = np.zeros((cap, 3), np.float32)
            tgt_pad[:n] = pts1[nn01]
            valid = (np.arange(cap) < n).astype(np.float32)
        with self._stage("solve"):
            T_dev, wsum_dev, w_dev = self._solve(
                uniq_logits, self._tensor(inv_pad, torch.int64),
                self._tensor(src_pad), self._tensor(tgt_pad),
                self._tensor(valid), cfg.clip_weight_thresh,
                2.0 * cfg.voxel_size)
            T = T_dev.cpu().numpy()
            wsum = float(wsum_dev)
            weights = w_dev[:n].cpu().numpy()

        used_safeguard = False
        min_w = max(cfg.safeguard_min_weight, cfg.safeguard_min_frac * n)
        if (not np.isfinite(wsum) or wsum < min_w
                or not np.all(np.isfinite(T))):
            # the wsum gate / a NaN T -> RANSAC safeguard (ref :330,
            # 348-396)
            T = self.safeguard_registration(src_pad[:n], tgt_pad[:n])
            used_safeguard = True

        if cfg.use_icp:
            # ICP registers the WHOLE voxelized clouds (ref :286-289,
            # 398-406), not just the matched subset
            with self._stage("icp"), torch.no_grad():
                T = icp_refine(self._tensor(pts0), self._tensor(pts1),
                               self._tensor(T),
                               max_corr_dist=2 * cfg.voxel_size,
                               num_iters=cfg.icp_max_iters).cpu().numpy()

        return {
            "trans": T,
            "weights": weights,
            "corres": (e0["sel"], nn01),
            "used_safeguard": used_safeguard,
        }
