"""Reprojection residual and analytic Jacobians (counterpart of
``stereo_vo_tpu/backend/residuals.py``).

    gamma = R(q) p / |q|^2 + t          # world point into the camera frame,
                                        # valid for NON-unit quaternions
    r     = K_{2x3} * gamma / gamma_z - obs

with ``q`` w-first, pose = T_cw and ``K = [[f, 0, cx], [0, f, cy]]``; the
2x7 (pose) and 2x3 (landmark) Jacobians in closed form, batched over any
leading observation dims.
"""

from __future__ import annotations

from typing import Tuple

import torch

from vobench.reference.core.camera import CameraInfo
from vobench.reference.core.geometry import pose_q, pose_t, rot_apply


def _gamma(pose: torch.Tensor, point: torch.Tensor) -> torch.Tensor:
    return rot_apply(pose_q(pose), point) + pose_t(pose)


def reprojection_residual(
    pose: torch.Tensor,
    point: torch.Tensor,
    obs: torch.Tensor,
    cam: CameraInfo,
) -> torch.Tensor:
    """``[..., 2]`` residual ``K gamma / gamma_z - obs``."""
    g = _gamma(pose, point)
    z = g[..., 2:3]
    uv = g[..., 0:2] / z
    return uv * cam.focal + cam.principal_point(uv) - obs


def _skew_rows(a, b, c, zero):
    """Rows of ``[[0, -c, b], [c, 0, -a], [-b, a, 0]]`` flattened (skew of (a, b, c))."""
    return [zero, -c, b, c, zero, -a, -b, a, zero]


def reprojection_jacobians(
    pose: torch.Tensor,
    point: torch.Tensor,
    obs: torch.Tensor,
    cam: CameraInfo,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Residual + analytic Jacobians:
    ``(r [..., 2], J_pose [..., 2, 7], J_point [..., 2, 3])``."""
    dtype, device = pose.dtype, pose.device
    q = pose_q(pose)
    w = q[..., 0:1]
    v = q[..., 1:4]
    t = pose_t(pose)
    n2 = torch.sum(q * q, dim=-1, keepdim=True)

    # unnormalized rotated point u = R_un(q) p ; gamma = u / n2 + t
    vdotp = torch.sum(v * point, dim=-1, keepdim=True)
    vdotv = torch.sum(v * v, dim=-1, keepdim=True)
    vb, pb = torch.broadcast_tensors(v, point)
    vxp = torch.linalg.cross(vb, pb, dim=-1)
    u = 2.0 * vdotp * v + (w * w - vdotv) * point + 2.0 * w * vxp
    g = u / n2 + t

    gx, gy, gz = g[..., 0], g[..., 1], g[..., 2]
    inv_z = 1.0 / gz
    f = cam.focal

    zero = torch.zeros_like(gx)
    dr_dg = torch.stack(
        [
            f * inv_z, zero, -f * gx * inv_z * inv_z,
            zero, f * inv_z, -f * gy * inv_z * inv_z,
        ],
        dim=-1,
    ).reshape(g.shape[:-1] + (2, 3))

    # d(R_un p)/dq [..., 3, 4]
    du_dw = 2.0 * (w * point + vxp)
    eye3 = torch.eye(3, dtype=dtype, device=device)
    vpT = v[..., :, None] * point[..., None, :]
    pvT = point[..., :, None] * v[..., None, :]
    pz_ = point.expand(g.shape)
    px, py, pz = pz_[..., 0], pz_[..., 1], pz_[..., 2]
    skew_p = torch.stack(_skew_rows(px, py, pz, zero), dim=-1).reshape(g.shape[:-1] + (3, 3))
    du_dv = 2.0 * (vpT + vdotp[..., None] * eye3 - pvT - w[..., None] * skew_p)
    du_dq = torch.cat([du_dw[..., :, None], du_dv], dim=-1)        # [..., 3, 4]

    # dgamma/dq = du_dq / n2 - 2 u q^T / n2^2
    dg_dq = du_dq / n2[..., None] - (
        2.0 * u[..., :, None] * q[..., None, :] / (n2 * n2)[..., None]
    )

    # dgamma/dp = R(q) / |q|^2
    vv = v.expand(g.shape)
    skew_v = torch.stack(_skew_rows(vv[..., 0], vv[..., 1], vv[..., 2], zero),
                         dim=-1).reshape(g.shape[:-1] + (3, 3))
    rmat = (
        2.0 * (v[..., :, None] * v[..., None, :])
        + (w * w - vdotv)[..., None] * eye3
        + 2.0 * w[..., None] * skew_v
    ) / n2[..., None]

    j_q = torch.sum(dr_dg[..., :, :, None] * dg_dq[..., None, :, :], dim=-2)
    j_pose = torch.cat([j_q, dr_dg], dim=-1)                         # [..., 2, 7]
    j_point = torch.sum(dr_dg[..., :, :, None] * rmat[..., None, :, :], dim=-2)

    uvz = torch.stack([gx, gy], dim=-1) * inv_z[..., None]
    r = uvz * f + cam.principal_point(uvz) - obs
    return r, j_pose, j_point
