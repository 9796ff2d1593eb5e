"""Trajectory file I/O: KITTI and TUM formats.

The offline replacement for the reference's ``/vo/path`` + TF publication
(``vo_node.cpp:153-185``): trajectories are written as standard files that
kitti-odometry / evo-style tooling can consume.

- KITTI format: one 3x4 row-major camera-to-world matrix per line.
- TUM format: ``stamp tx ty tz qx qy qz qw`` per line (note x-y-z-w quat order).

Copied from ``stereo_vo_tpu/eval/trajectory.py`` with the pose algebra done by
this package's geometry; the KITTI ground-truth loader waits for the KITTI
data layer.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from stereo_vo_tpu_torch.core import geometry as geo


def _as_tensor(poses: np.ndarray) -> torch.Tensor:
    return torch.as_tensor(np.asarray(poses, np.float32))


def poses_to_positions(poses_tcw: np.ndarray) -> np.ndarray:
    """``[N, 7]`` T_cw -> ``[N, 3]`` world-frame camera centers."""
    return geo.pose_inverse(_as_tensor(poses_tcw))[..., 4:7].numpy()


def write_kitti_trajectory(path: str, poses_tcw: np.ndarray) -> None:
    inv = geo.pose_inverse(_as_tensor(poses_tcw))
    r_wc = geo.quat_to_rotmat(inv[..., 0:4]).numpy()
    t_wc = inv[..., 4:7].numpy()
    rows = np.concatenate([r_wc, t_wc[..., None]], axis=-1).reshape(-1, 12)
    np.savetxt(path, rows, fmt="%.9e")


def write_tum_trajectory(
    path: str, poses_tcw: np.ndarray, stamps: Optional[np.ndarray] = None
) -> None:
    inv = geo.pose_inverse(_as_tensor(poses_tcw)).numpy()
    if stamps is None:
        stamps = np.arange(len(inv), dtype=np.float64)
    with open(path, "w") as f:
        for s, p in zip(stamps, inv):
            qw, qx, qy, qz, tx, ty, tz = p
            f.write(f"{s:.6f} {tx:.9f} {ty:.9f} {tz:.9f} {qx:.9f} {qy:.9f} {qz:.9f} {qw:.9f}\n")


def load_tum_trajectory(path: str) -> np.ndarray:
    """TUM file -> ``[N, 7]`` T_cw pose vectors (inverting the stored T_wc)."""
    data = np.loadtxt(path).reshape(-1, 8)
    t_wc = data[:, 1:4]
    q_xyzw = data[:, 4:8]
    q_wc = np.concatenate([q_xyzw[:, 3:4], q_xyzw[:, 0:3]], axis=1)
    pose_wc = _as_tensor(np.concatenate([q_wc, t_wc], axis=1))
    return geo.pose_inverse(pose_wc).numpy()
