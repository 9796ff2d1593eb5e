"""Sliding-window bundle-adjustment state (counterpart of
``stereo_vo_tpu/backend/window.py``).

Fixed-shape masked arrays:

- ``poses``       ``[W, 7]``    T_cw per keyframe, chronological (oldest at 0)
- ``obs_uv/lm``   ``[W, F, 2] / [W, F]`` per-keyframe observations -> landmark ids
- ``lm_pos``      ``[L, 3]``    landmark table
- ``lm_refcount`` ``[L]``       windowed observation count

A new landmark's refcount starts at exactly 1; eviction frees slots and ids
recycle lowest index first; the ``max_features`` cap truncates features,
points and ids coherently. Each landmark carries a stereo-triangulation prior
(position and inverse variance) that anchors the window's scale.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from stereo_vo_tpu_torch.core.config import BackendConfig


class WindowState(NamedTuple):
    poses: torch.Tensor        # [W, 7] float
    pose_valid: torch.Tensor   # [W] bool
    obs_uv: torch.Tensor       # [W, F, 2] float
    obs_lm: torch.Tensor       # [W, F] int32
    obs_valid: torch.Tensor    # [W, F] bool
    lm_pos: torch.Tensor       # [L, 3] float
    lm_refcount: torch.Tensor  # [L] int32
    lm_valid: torch.Tensor     # [L] bool
    lm_prior: torch.Tensor     # [L, 3] float, prior position
    lm_prior_w: torch.Tensor   # [L] float, prior inverse variance (0 = none)
    num_kf: torch.Tensor       # [] int32, keyframes ever added
    ba_lam: Optional[torch.Tensor] = None  # [] float, LM damping carried across solves

    @property
    def window_size(self) -> int:
        return self.poses.shape[0]

    @property
    def feature_capacity(self) -> int:
        return self.obs_uv.shape[1]

    @property
    def landmark_capacity(self) -> int:
        return self.lm_pos.shape[0]


def empty_window(cfg: BackendConfig, dtype=torch.float32, device=None) -> WindowState:
    w, f, l = cfg.window_size, cfg.feature_capacity, cfg.landmark_capacity
    return WindowState(
        poses=torch.tensor([1.0, 0, 0, 0, 0, 0, 0], dtype=dtype, device=device).repeat(w, 1),
        pose_valid=torch.zeros((w,), dtype=torch.bool, device=device),
        obs_uv=torch.zeros((w, f, 2), dtype=dtype, device=device),
        obs_lm=torch.zeros((w, f), dtype=torch.int32, device=device),
        obs_valid=torch.zeros((w, f), dtype=torch.bool, device=device),
        lm_pos=torch.zeros((l, 3), dtype=dtype, device=device),
        lm_refcount=torch.zeros((l,), dtype=torch.int32, device=device),
        lm_valid=torch.zeros((l,), dtype=torch.bool, device=device),
        lm_prior=torch.zeros((l, 3), dtype=dtype, device=device),
        lm_prior_w=torch.zeros((l,), dtype=dtype, device=device),
        num_kf=torch.tensor(0, dtype=torch.int32, device=device),
        ba_lam=torch.tensor(cfg.init_damping, dtype=dtype, device=device),
    )


def valid_first(valid: torch.Tensor) -> torch.Tensor:
    """Stable permutation putting valid entries first (original order kept)."""
    return torch.sort((~valid).to(torch.uint8), stable=True).indices


def add_keyframe(
    state: WindowState,
    cfg: BackendConfig,
    pose: torch.Tensor,
    tracked_uv: torch.Tensor,
    tracked_lm: torch.Tensor,
    tracked_valid: torch.Tensor,
    new_uv: torch.Tensor,
    new_p3: torch.Tensor,
    new_valid: torch.Tensor,
    new_prior_w: torch.Tensor = None,
    tracked_prior_pos: torch.Tensor = None,
    tracked_prior_w: torch.Tensor = None,
) -> Tuple[WindowState, torch.Tensor, torch.Tensor]:
    """Add a keyframe; evict the oldest pose if the window overflows.

    Tracked observations re-reference live landmarks; new features claim the
    lowest free landmark ids; the keyframe's observation count is capped at
    ``cfg.max_features`` by truncating new features. Returns
    ``(new_state, new_ids [F] int32, new_ids_valid [F])``.
    """
    f_cap = state.feature_capacity
    l_cap = state.landmark_capacity
    device = pose.device

    # cap new features: max_new = max_features - num_tracked
    num_tracked = torch.sum(tracked_valid.to(torch.int32))
    max_new = torch.clamp(cfg.max_features - num_tracked, min=0)
    new_rank = torch.cumsum(new_valid.to(torch.int32), dim=0) - 1
    new_valid = new_valid & (new_rank < max_new)

    # lowest free slots first, clamped to the number of free slots
    num_free = l_cap - torch.sum(state.lm_valid.to(torch.int32))
    new_valid = new_valid & (new_rank < num_free)
    free_order = valid_first(~state.lm_valid)
    new_ids = free_order[torch.clamp(new_rank, 0, l_cap - 1).to(torch.int64)].to(torch.int32)
    new_ids = torch.where(new_valid, new_ids, 0)
    sel = new_ids[new_valid].to(torch.int64)

    # write new landmarks (refcount exactly 1)
    lm_pos = state.lm_pos.clone()
    lm_pos[sel] = new_p3[new_valid]
    lm_refcount = state.lm_refcount.clone()
    lm_refcount[sel] += 1
    lm_valid = state.lm_valid.clone()
    lm_valid[sel] = True
    if new_prior_w is None:
        new_prior_w = torch.zeros(new_valid.shape, dtype=state.lm_prior_w.dtype, device=device)
    lm_prior = state.lm_prior
    lm_prior_w = state.lm_prior_w

    # stereo-prior refresh for tracked landmarks: information-filter fusion
    if tracked_prior_w is not None:
        tw = torch.where(tracked_valid, tracked_prior_w, 0.0)
        upd = tw > 0
        t_ids = tracked_lm[upd].to(torch.int64)
        num = lm_prior * lm_prior_w[:, None]
        num = num.index_add(0, t_ids, tw[upd][:, None] * tracked_prior_pos[upd])
        lm_prior_w = lm_prior_w.index_add(0, t_ids, tw[upd])
        lm_prior = torch.where(
            (lm_prior_w > 0)[:, None],
            num / torch.clamp(lm_prior_w, min=1e-20)[:, None],
            lm_prior,
        )

    lm_prior = lm_prior.clone()
    lm_prior[sel] = new_p3[new_valid]
    lm_prior_w = lm_prior_w.clone()
    lm_prior_w[sel] = new_prior_w[new_valid]

    # tracked features bump their landmarks' refcounts
    lm_refcount = lm_refcount.index_add(
        0, tracked_lm[tracked_valid].to(torch.int64),
        torch.ones_like(tracked_lm[tracked_valid]),
    )

    # this keyframe's packed observation row: tracked first, then new
    cat_uv = torch.cat([tracked_uv, new_uv], dim=0)
    cat_lm = torch.cat([tracked_lm, new_ids], dim=0)
    cat_valid = torch.cat([tracked_valid, new_valid], dim=0)
    order = valid_first(cat_valid)[:f_cap]
    row_valid, row_uv, row_lm = cat_valid[order], cat_uv[order], cat_lm[order]
    row_valid = row_valid & (torch.cumsum(row_valid.to(torch.int32), dim=0) <= cfg.max_features)

    # insert chronologically (oldest at index 0), evicting the oldest if full
    poses = state.poses
    obs_uv, obs_lm, obs_valid = state.obs_uv, state.obs_lm, state.obs_valid
    pose_valid = state.pose_valid
    if int(state.num_kf) >= state.window_size:
        ev = obs_valid[0]
        lm_refcount = lm_refcount.index_add(
            0, obs_lm[0][ev].to(torch.int64), -torch.ones_like(obs_lm[0][ev]))
        lm_valid = lm_valid & (lm_refcount > 0)
        lm_refcount = torch.clamp(lm_refcount, min=0)
        poses = torch.roll(poses, -1, dims=0)
        obs_uv = torch.roll(obs_uv, -1, dims=0)
        obs_lm = torch.roll(obs_lm, -1, dims=0)
        obs_valid = torch.roll(obs_valid, -1, dims=0)
        idx = state.window_size - 1
    else:
        poses, obs_uv, obs_lm, obs_valid = (
            poses.clone(), obs_uv.clone(), obs_lm.clone(), obs_valid.clone())
        pose_valid = pose_valid.clone()
        idx = int(state.num_kf)
        pose_valid[idx] = True
    poses[idx] = pose
    obs_uv[idx] = row_uv
    obs_lm[idx] = row_lm
    obs_valid[idx] = row_valid

    out = state._replace(
        poses=poses, pose_valid=pose_valid, obs_uv=obs_uv, obs_lm=obs_lm,
        obs_valid=obs_valid, lm_pos=lm_pos, lm_refcount=lm_refcount,
        lm_valid=lm_valid, lm_prior=lm_prior, lm_prior_w=lm_prior_w,
        num_kf=state.num_kf + 1,
    )
    return out, new_ids, new_valid


def newest_pose(state: WindowState) -> torch.Tensor:
    """The most recent keyframe's T_cw (the pose the reference publishes)."""
    idx = torch.clamp(state.num_kf - 1, 0, state.window_size - 1).to(torch.int64)
    return state.poses[idx]


def get_world_points(state: WindowState, ids: torch.Tensor) -> torch.Tensor:
    """Landmark id -> 3d position lookup."""
    return state.lm_pos[ids.to(torch.int64)]
