"""PointDSC configuration presets, the reference's hyperparameters.

Counterpart of the PointDSC part of ``gmf_tpu/configs/presets.py``.
Sources:

- GMF_PointDSC/config_3DMatch.py: inlier threshold 0.10, sigma_d 0.10,
  success 15 deg / 30 cm, Adam 1e-4, ExpLR 0.99, batch 16, num_node 1000,
  augmentation axis 3 / rotation 1.0 / translation 0.5;
- GMF_PointDSC/config_Kitti.py: inlier threshold 1.2, sigma_d 1.2,
  success 5 deg / 60 cm, batch 2, downsample 0.30.
- GMF_DGR config_3DMatch.py / config_Kitti.py: voxel 0.05 / 0.3, SGD
  lr 0.1 / 1e-2, clip_weight_thresh 0.05, FCGF conv1 kernel 7 / 5
  (``DGRTrainConfig``, ``dgr_3dmatch``, ``dgr_kitti``; the DGR
  evaluation command line reads its voxel sizes and thresholds here).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional


@dataclasses.dataclass
class ModelConfig:
    """PointDSC network hyperparameters (config group Network)."""

    in_dim: int = 6
    num_layers: int = 12
    num_channels: int = 128
    num_iterations: int = 10
    ratio: float = 0.1
    k: int = 40
    inlier_threshold: float = 0.10
    sigma_d: float = 0.10
    nms_radius: float = 0.10


@dataclasses.dataclass
class DataConfig:
    root: str = ""
    overlap_path: str = ""
    descriptor: str = "fcgf"
    num_node: object = 1000
    use_mutual: bool = False
    downsample: float = 0.03
    augment_axis: int = 3
    augment_rotation: float = 1.0
    augment_translation: float = 0.5
    image_H: int = 120
    image_W: int = 160
    batch_size: int = 16


@dataclasses.dataclass
class GMFConfig:
    """Network, data, training and evaluation settings together."""

    dataset: str = "3DMatch"
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    # training (config groups Loss and Optimizer)
    lr: float = 1e-4
    weight_decay: float = 1e-6
    scheduler_gamma: float = 0.99
    max_epoch: int = 100
    training_max_iter: int = 3500
    val_max_iter: int = 1000
    weight_classification: float = 1.0
    weight_spectralmatching: float = 1.0
    weight_transformation: float = 0.0
    transformation_loss_start_epoch: int = 0
    balanced: bool = False
    # evaluation success thresholds
    re_thre: float = 15.0
    te_thre: float = 30.0  # cm

    def to_json(self, path: Optional[str] = None) -> str:
        s = json.dumps(dataclasses.asdict(self), indent=2, default=str)
        if path:
            with open(path, "w") as f:
                f.write(s)
        return s

    @classmethod
    def from_json(cls, path_or_str: str) -> "GMFConfig":
        try:
            d = json.loads(path_or_str)
        except json.JSONDecodeError:
            with open(path_or_str) as f:
                d = json.load(f)
        d["model"] = ModelConfig(**d.get("model", {}))
        d["data"] = DataConfig(**d.get("data", {}))
        return cls(**d)


def pointdsc_3dmatch(**overrides) -> GMFConfig:
    cfg = GMFConfig()
    for k, v in overrides.items():
        setattr(cfg, k, v)
    return cfg


def pointdsc_kitti(**overrides) -> GMFConfig:
    cfg = GMFConfig(
        dataset="Kitti",
        model=ModelConfig(inlier_threshold=1.2, sigma_d=1.2),
        data=DataConfig(descriptor="fcgf", downsample=0.30, batch_size=2,
                        augment_translation=0.5),
        re_thre=5.0,
        te_thre=60.0,
    )
    for k, v in overrides.items():
        setattr(cfg, k, v)
    return cfg


@dataclasses.dataclass
class DGRTrainConfig:
    """DGR trainer hyperparameters (GMF_DGR config_3DMatch.py defaults,
    KITTI deltas in dgr_kitti)."""

    voxel_size: float = 0.05
    optimizer: str = "SGD"
    lr: float = 0.1
    momentum: float = 0.8
    weight_decay: float = 1e-4
    exp_gamma: float = 0.99
    max_epoch: int = 100
    batch_size: int = 4
    iter_size: int = 1
    inlier_feature_type: str = "ones"
    clip_weight_thresh: float = 0.05
    inlier_conv1_kernel_size: int = 3
    feat_conv1_kernel_size: int = 7
    procrustes_loss_weight: float = 1.0
    trans_weight: float = 1.0
    inlier_weight: float = 1.0
    success_rte_thresh: float = 0.3
    success_rre_thresh: float = 15.0
    best_val_metric: str = "succ_rate"


def dgr_3dmatch(**overrides) -> DGRTrainConfig:
    cfg = DGRTrainConfig()
    for k, v in overrides.items():
        setattr(cfg, k, v)
    return cfg


def dgr_kitti(**overrides) -> DGRTrainConfig:
    cfg = DGRTrainConfig(
        voxel_size=0.3, lr=1e-2, feat_conv1_kernel_size=5,
        success_rte_thresh=2.0, success_rre_thresh=5.0,
    )
    for k, v in overrides.items():
        setattr(cfg, k, v)
    return cfg
