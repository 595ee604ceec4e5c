from gmf_tpu_torch.configs.presets import (DataConfig, GMFConfig,
                                           ModelConfig, pointdsc_3dmatch,
                                           pointdsc_kitti)

__all__ = ["DataConfig", "GMFConfig", "ModelConfig", "pointdsc_3dmatch",
           "pointdsc_kitti"]
