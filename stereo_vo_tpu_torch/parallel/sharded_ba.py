"""Landmark-sharded distributed bundle adjustment (counterpart of
``stereo_vo_tpu/parallel/sharded_ba.py``).

Landmark blocks are independent in the Schur complement, so the landmark
table and its landmark-major observations split across the ``"lm"`` axis of
a mesh (``parallel/mesh.py``), the reference's ``P("lm")`` layout:

    per rank:    residuals + Jacobians for its contiguous block [L/n, W],
                 its part of the reduced camera system
    all-reduce:  the pose blocks per accepted build, the [6W+1, 6W+1] Schur
                 block per damping attempt, the costs (sum over the group)
    replicated:  the dense (6W)^2 solve, identical on every rank
    per rank:    back-substitution of its own landmarks

The solver is ``backend.schur.lm_loop`` with the group passed in, so sharded
equals single-device up to the order of the sums. Every rank of the mesh
calls these functions with the same full problem; each returns the full
result (the landmark blocks are all-gathered over the group).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

from stereo_vo_tpu_torch.backend.schur import (
    LandmarkMajorProblem,
    lm_loop,
    window_to_landmark_major,
)
from stereo_vo_tpu_torch.backend.window import WindowState
from stereo_vo_tpu_torch.core.camera import CameraInfo
from stereo_vo_tpu_torch.core.config import BackendConfig
from stereo_vo_tpu_torch.parallel.distributed import local_dp_block

_LM_FIELDS = ("lm_pos", "lm_valid", "obs_uv", "obs_valid", "lm_prior", "lm_prior_w")


def _axis_size(mesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def _check(mesh, tensors) -> None:
    """Raise unless the world is up, this rank is in ``mesh`` and every
    tensor lies on the mesh's device type."""
    if not dist.is_initialized():
        raise RuntimeError("sharded solve needs an initialized process group")
    if mesh.get_coordinate() is None:
        raise ValueError(f"rank {dist.get_rank()} is not in the mesh")
    for t in tensors:
        if t.device.type != mesh.device_type:
            raise ValueError(f"tensor on {t.device}, mesh on {mesh.device_type!r}")


def _all_gather(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """Concatenate every rank's ``x`` along dim 0, in group-rank order."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=0)


def sharded_lm_solve(
    prob: LandmarkMajorProblem,
    cam: CameraInfo,
    cfg: BackendConfig,
    mesh,
    lm_axis: str = "lm",
):
    """Landmark-sharded LM solve of a landmark-major problem.

    Returns ``(poses, lm_pos, cost0, cost1)`` with the full ``lm_pos`` on
    every rank; equals the single-device ``lm_loop`` up to summation order."""
    _check(mesh, prob)
    n = _axis_size(mesh, lm_axis)
    lcap = prob.lm_pos.shape[0]
    if lcap % n != 0:
        raise ValueError(f"landmark capacity {lcap} not divisible by {n} shards")
    i, blk = mesh.get_local_rank(lm_axis), lcap // n
    local = prob._replace(**{f: getattr(prob, f)[i * blk:(i + 1) * blk] for f in _LM_FIELDS})
    group = mesh.get_group(lm_axis)
    poses, lm_pos, c0, c1, *_ = lm_loop(local, cam, cfg, group=group)
    return poses, _all_gather(lm_pos, group, n), c0, c1


def sharded_bundle_adjust(
    window: WindowState,
    cam: CameraInfo,
    cfg: BackendConfig,
    mesh,
    lm_axis: str = "lm",
) -> Tuple[WindowState, torch.Tensor, torch.Tensor]:
    """Distributed BA over ``mesh``, the landmark table split along
    ``lm_axis``. Returns ``(window', initial_cost, final_cost)``; the result
    equals ``backend.schur.bundle_adjust`` on a window without a carried
    damping (same damping schedule, same reduced system)."""
    poses, lm_pos, cost0, cost1 = sharded_lm_solve(window_to_landmark_major(window), cam, cfg,
                                                   mesh, lm_axis)
    return window._replace(poses=poses, lm_pos=lm_pos), cost0, cost1


def dp_sharded_bundle_adjust(
    batch: LandmarkMajorProblem,
    cam: CameraInfo,
    cfg: BackendConfig,
    mesh,
    dp_axis: str = "dp",
    lm_axis: str = "lm",
):
    """Data-parallel batch of landmark-sharded solves over a 2-D mesh.

    ``batch`` carries a leading batch dimension on every array (independent
    windows). Each ``dp`` rank solves its block of windows one after the
    other, each sharded over its ``lm`` group; the results are gathered over
    ``dp``. Returns ``(poses [B, W, 7], lm_pos [B, L, 3], cost0 [B],
    cost1 [B])`` on every rank, each window's result that of its own solve."""
    _check(mesh, batch)
    local = local_dp_block(batch, mesh, dp_axis)
    outs = [sharded_lm_solve(LandmarkMajorProblem(*[x[b] for x in local]), cam, cfg,
                             mesh, lm_axis)
            for b in range(local.poses.shape[0])]
    group, n = mesh.get_group(dp_axis), _axis_size(mesh, dp_axis)
    return tuple(_all_gather(torch.stack([o[k] for o in outs]), group, n) for k in range(4))
