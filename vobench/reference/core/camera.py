"""Pinhole stereo camera model (counterpart of ``stereo_vo_tpu/core/camera.py``).

Focal length, principal point, four distortion coefficients and the stereo
baseline. The distortion fields are carried for config parity only: every
call site in the reference passes zeros.
"""

from __future__ import annotations

import dataclasses

import torch

from vobench.reference.core.consts import const


@dataclasses.dataclass(frozen=True)
class CameraInfo:
    """Static (hashable) camera parameters."""

    focal: float
    cx: float
    cy: float
    baseline: float
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0

    def intrinsic_matrix(self, dtype=torch.float32, device=None) -> torch.Tensor:
        """3x3 camera matrix K."""
        return torch.tensor(
            [[self.focal, 0.0, self.cx],
             [0.0, self.focal, self.cy],
             [0.0, 0.0, 1.0]],
            dtype=dtype, device=device,
        )

    def projection_2x3(self, dtype=torch.float32, device=None) -> torch.Tensor:
        """The 2x3 K used by the reprojection residual."""
        return torch.tensor(
            [[self.focal, 0.0, self.cx],
             [0.0, self.focal, self.cy]],
            dtype=dtype, device=device,
        )

    def reprojection_q(self, dtype=torch.float32, device=None) -> torch.Tensor:
        """4x4 disparity-to-depth matrix Q: ``[X Y Z W]^T = Q @ [u v d 1]^T``."""
        f, cx, cy, b = self.focal, self.cx, self.cy, self.baseline
        return torch.tensor(
            [[1.0 / f, 0.0, 0.0, -cx / f],
             [0.0, 1.0 / f, 0.0, -cy / f],
             [0.0, 0.0, 0.0, 1.0],
             [0.0, 0.0, 1.0 / (b * f), 0.0]],
            dtype=dtype, device=device,
        )

    def principal_point(self, like: torch.Tensor) -> torch.Tensor:
        """``[cx, cy]`` in ``like``'s dtype and device, made once (``core/consts.py``)."""
        return const([self.cx, self.cy], like.dtype, like.device)

    def project(self, p_cam: torch.Tensor) -> torch.Tensor:
        """Project ``[..., 3]`` camera-frame points to ``[..., 2]`` pixels."""
        z = p_cam[..., 2:3]
        uv = p_cam[..., 0:2] / z
        return uv * self.focal + self.principal_point(p_cam)

    def back_project(self, uv: torch.Tensor, disparity: torch.Tensor) -> torch.Tensor:
        """``[..., 2]`` pixels + ``[...]`` disparity -> ``[..., 3]`` camera-frame
        points (dehomogenized ``Q @ [u, v, d, 1]``)."""
        d = disparity[..., None]
        # ``scalar / tensor`` in torch is ``reciprocal * scalar`` (two roundings);
        # divide a filled tensor instead so the result is one correctly rounded
        # f32 division, as in the reference
        z = torch.full_like(d, self.focal * self.baseline) / d
        x = (uv[..., 0:1] - self.cx) / self.focal * z
        y = (uv[..., 1:2] - self.cy) / self.focal * z
        return torch.cat([x, y, z], dim=-1)
