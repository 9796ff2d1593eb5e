"""Stereo triangulation from per-feature disparities (counterpart of
``stereo_vo_tpu/frontend/triangulate.py::triangulate_from_disparities``)."""

from __future__ import annotations

from typing import Tuple

import torch

from stereo_vo_tpu_torch.core.camera import CameraInfo
from stereo_vo_tpu_torch.core.geometry import camera_to_world_matrix


def triangulate_from_disparities(
    disp: torch.Tensor,
    xy: torch.Tensor,
    valid: torch.Tensor,
    cam: CameraInfo,
    pose_cw: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(points_world [F, 3], valid [F])``: features with ``disp > 0``
    back-projected and moved to the world by the camera-to-world matrix of
    ``pose_cw`` (T_cw)."""
    ok = valid & (disp > 0)
    safe_disp = torch.where(ok, disp, 1.0)
    p_cam = cam.back_project(xy, safe_disp)             # [F, 3]
    c2w = camera_to_world_matrix(pose_cw)               # [4, 4]
    p_world = p_cam @ c2w[:3, :3].T + c2w[:3, 3]
    return torch.where(ok[:, None], p_world, 0.0), ok
