"""Stereo triangulation of detected features (counterpart of
``stereo_vo_tpu/frontend/triangulate.py``): from a dense disparity map
(``triangulate_features``) or from per-feature disparities
(``triangulate_from_disparities``, the sparse ``stereo_bm_at`` path the
engine takes)."""

from __future__ import annotations

from typing import Tuple

import torch

from vobench.reference.core.camera import CameraInfo
from vobench.reference.core.geometry import camera_to_world_matrix
from vobench.reference.ops.stereo_bm import disparity_at


def triangulate_features(
    disparity: torch.Tensor,
    xy: torch.Tensor,
    valid: torch.Tensor,
    cam: CameraInfo,
    pose_cw: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(points_world [F, 3], valid [F])`` for features ``xy [F, 2]``
    of the camera at ``pose_cw`` (T_cw), reading the dense ``disparity [H,
    W]`` map at their truncated integer coordinates (OpenCV's
    ``disparity.at(y, x)``)."""
    return triangulate_from_disparities(disparity_at(disparity, xy), xy, valid, cam, pose_cw)


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
