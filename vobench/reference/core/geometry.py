"""Quaternion / SE(3) geometry in the reference's conventions (PyTorch).

Counterpart of ``stereo_vo_tpu/core/geometry.py``; the conventions are the
same:

- Quaternions are **w-first** ``[w, x, y, z]`` Hamilton quaternions.
- A pose is a 7-vector ``[qw qx qy qz, tx ty tz]`` storing **T_cw**:
  ``x_cam = R(q) @ x_world + t``.
- ``rot_apply`` is valid for **non-unit** quaternions
  (``R(q) p = (2 v v^T + (w^2 - v.v) I + 2 w skew(v)) p / |q|^2``).
- Publication inverts a pose: ``q_wc = conj(q_cw)``, ``t_wc = R(q_wc) (-t_cw)``.

Every function broadcasts over leading batch dims and keeps the input's dtype
and device.
"""

from __future__ import annotations

import torch

from vobench.reference.core.consts import const
from vobench.reference.core.f32 import sqrt_f32


def _const(values, like: torch.Tensor) -> torch.Tensor:
    return const(values, like.dtype, like.device)


# ---------------------------------------------------------------------------
# Quaternion primitives
# ---------------------------------------------------------------------------

def quat_identity(dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype, device=device)


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    """Conjugate of ``[..., 4]`` w-first quaternions."""
    return q * _const([1.0, -1.0, -1.0, -1.0], q)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product ``a ⊗ b`` of ``[..., 4]`` w-first quaternions."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    n = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return q / torch.clamp(n, min=eps)


def rot_apply(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Rotate ``[..., 3]`` vectors by ``[..., 4]`` (possibly non-unit) quaternions."""
    w = q[..., 0:1]
    v = q[..., 1:4]
    n2 = torch.sum(q * q, dim=-1, keepdim=True)
    v, p = torch.broadcast_tensors(v, p)
    vp = torch.linalg.cross(v, p, dim=-1)
    vdotp = torch.sum(v * p, dim=-1, keepdim=True)
    vdotv = torch.sum(v * v, dim=-1, keepdim=True)
    rp = 2.0 * vdotp * v + (w * w - vdotv) * p + 2.0 * w * vp
    return rp / n2


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """``[..., 4]`` quaternion -> ``[..., 3, 3]`` rotation matrix (normalizing)."""
    q = quat_normalize(q)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r = torch.stack(
        [
            1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
            2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
            2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
        ],
        dim=-1,
    )
    return r.reshape(q.shape[:-1] + (3, 3))


def rotmat_to_quat(m: torch.Tensor) -> torch.Tensor:
    """``[..., 3, 3]`` rotation matrix -> unit w-first quaternion (Shepperd's
    method over all four candidates, the largest pivot selected, ``w >= 0``)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    qw = torch.stack([1 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx = torch.stack([m21 - m12, 1 + m00 - m11 - m22, m01 + m10, m02 + m20], dim=-1)
    qy = torch.stack([m02 - m20, m01 + m10, 1 - m00 + m11 - m22, m12 + m21], dim=-1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1 - m00 - m11 + m22], dim=-1)

    pivots = torch.stack([1 + tr, 1 + m00 - m11 - m22, 1 - m00 + m11 - m22,
                          1 - m00 - m11 + m22], dim=-1)
    best = torch.argmax(pivots, dim=-1)
    cands = torch.stack([qw, qx, qy, qz], dim=-2)  # [..., 4(cand), 4(comp)]
    idx = best[..., None, None].expand(best.shape + (1, 4))
    q = torch.gather(cands, -2, idx)[..., 0, :]
    q = quat_normalize(q)
    return q * torch.where(q[..., 0:1] < 0, -1.0, 1.0).to(q.dtype)


# ---------------------------------------------------------------------------
# Tangent-space retraction
# ---------------------------------------------------------------------------

def quat_exp(delta: torch.Tensor) -> torch.Tensor:
    """Exponential map ``R^3 -> S^3``: ``[cos|δ|, sinc|δ| · δ]`` (w-first)."""
    n2 = torch.sum(delta * delta, dim=-1, keepdim=True)
    n = sqrt_f32(n2)
    small = n < 1e-8
    w = torch.where(small, 1.0 - n2 / 2.0, torch.cos(n))
    nc = torch.clamp(n, min=1e-20)
    s = torch.where(small, 1.0 - n2 / 6.0, torch.sin(nc) / nc)
    return torch.cat([w, s * delta], dim=-1)


def quat_retract(q: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """``q ⊞ δ = exp(δ) ⊗ q`` for ``[..., 4]`` quats and ``[..., 3]`` tangents."""
    return quat_mul(quat_exp(delta), q)


def quat_lift_jacobian(q: torch.Tensor) -> torch.Tensor:
    """``d(exp(δ) ⊗ q)/dδ`` at ``δ = 0``: the ``[..., 4, 3]`` lift matrix."""
    w = q[..., 0]
    x, y, z = q[..., 1], q[..., 2], q[..., 3]
    j = torch.stack(
        [
            -x, -y, -z,
            w, z, -y,
            -z, w, x,
            y, -x, w,
        ],
        dim=-1,
    )
    return j.reshape(q.shape[:-1] + (4, 3))


# ---------------------------------------------------------------------------
# Axis-angle (Rodrigues)
# ---------------------------------------------------------------------------

def axis_angle_to_quat(rvec: torch.Tensor) -> torch.Tensor:
    """Rodrigues vector ``[..., 3]`` -> w-first quaternion (``exp(rvec/2)``)."""
    return quat_exp(rvec / 2.0)


def quat_to_axis_angle(q: torch.Tensor) -> torch.Tensor:
    q = quat_normalize(q)
    q = q * torch.where(q[..., 0:1] < 0, -1.0, 1.0).to(q.dtype)
    w = torch.clamp(q[..., 0:1], -1.0, 1.0)
    v = q[..., 1:4]
    vn = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    angle = 2.0 * torch.atan2(vn, w)
    axis = v / torch.clamp(vn, min=1e-12)
    return torch.where(vn < 1e-12, 2.0 * v, angle * axis)


# ---------------------------------------------------------------------------
# SE(3) poses as 7-vectors [qw qx qy qz, tx ty tz] encoding T_cw
# ---------------------------------------------------------------------------

def pose_identity(dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.tensor([1.0, 0, 0, 0, 0, 0, 0], dtype=dtype, device=device)


def make_pose(q: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return torch.cat([q, t], dim=-1)


def pose_q(pose: torch.Tensor) -> torch.Tensor:
    return pose[..., 0:4]


def pose_t(pose: torch.Tensor) -> torch.Tensor:
    return pose[..., 4:7]


def pose_apply(pose: torch.Tensor, p_world: torch.Tensor) -> torch.Tensor:
    """``x_cam = R(q) p + t`` for a T_cw pose (non-unit-safe rotation)."""
    return rot_apply(pose_q(pose), p_world) + pose_t(pose)


def pose_inverse(pose: torch.Tensor) -> torch.Tensor:
    """Invert T_cw -> T_wc: ``q' = conj(q)``, ``t' = R(q') (-t)``."""
    qc = quat_conj(pose_q(pose))
    tw = rot_apply(qc, -pose_t(pose))
    return make_pose(qc, tw)


def pose_retract(pose: torch.Tensor, delta6: torch.Tensor) -> torch.Tensor:
    """Retraction on SE(3) as quaternion-manifold ⊗ Euclidean translation,
    ``delta6 = [δθ(3), δt(3)]``."""
    q = quat_retract(pose_q(pose), delta6[..., 0:3])
    t = pose_t(pose) + delta6[..., 3:6]
    return make_pose(q, t)


def pose_to_matrix(pose: torch.Tensor) -> torch.Tensor:
    """T_cw pose -> ``[..., 4, 4]`` homogeneous matrix."""
    r = quat_to_rotmat(pose_q(pose))
    t = pose_t(pose)[..., None]
    top = torch.cat([r, t], dim=-1)
    bottom = _const([0.0, 0.0, 0.0, 1.0], pose).expand(pose.shape[:-1] + (4,))[..., None, :]
    return torch.cat([top, bottom], dim=-2)


def camera_to_world_matrix(pose: torch.Tensor) -> torch.Tensor:
    """T_cw pose -> ``[..., 4, 4]`` camera-to-world matrix ``[R^T, -R^T t]``."""
    return pose_to_matrix(pose_inverse(pose))
