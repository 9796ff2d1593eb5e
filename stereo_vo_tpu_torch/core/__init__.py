from stereo_vo_tpu_torch.core.camera import CameraInfo
from stereo_vo_tpu_torch.core.config import (
    BackendConfig,
    FrontendConfig,
    PipelineConfig,
    RuntimeConfig,
    load_config,
)

__all__ = [
    "CameraInfo",
    "BackendConfig",
    "FrontendConfig",
    "PipelineConfig",
    "RuntimeConfig",
    "load_config",
]
