from stereo_vo_tpu_torch.backend.residuals import (
    reprojection_jacobians,
    reprojection_residual,
)
from stereo_vo_tpu_torch.backend.schur import BASolveStats, bundle_adjust
from stereo_vo_tpu_torch.backend.window import WindowState

__all__ = [
    "reprojection_residual",
    "reprojection_jacobians",
    "WindowState",
    "bundle_adjust",
    "BASolveStats",
]
