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

    Fixed shapes and no host read, as the reference's ``mode="drop"``
    scatters: masked rows go to a dump row past the landmark table, never
    scaled by zero (``tracked_prior_pos`` may hold inf), and the eviction is
    computed and selected on the device.
    """
    f_cap = state.feature_capacity
    l_cap = state.landmark_capacity
    w_cap = state.window_size
    device = pose.device

    def scatter(table, idx, values, add=False):
        """``table`` with rows ``idx`` set (or added to) from ``values``;
        index ``l_cap`` is a dump row past the table, cut off afterwards."""
        ext = torch.cat([table, torch.zeros_like(table[:1])])
        if add:
            return ext.index_add(0, idx, values)[:l_cap]
        ext[idx] = values
        return ext[:l_cap]

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
    scat = torch.where(new_valid, new_ids.to(torch.int64), l_cap)

    # write new landmarks (refcount exactly 1)
    lm_pos = scatter(state.lm_pos, scat, new_p3)
    lm_refcount = scatter(state.lm_refcount, scat, torch.ones_like(new_ids), add=True)
    lm_valid = scatter(state.lm_valid, scat, torch.ones_like(new_valid))
    if new_prior_w is None:
        new_prior_w = torch.zeros(new_valid.shape, dtype=state.lm_prior_w.dtype, device=device)
    lm_prior = state.lm_prior
    lm_prior_w = state.lm_prior_w

    # stereo-prior refresh for tracked landmarks: information-filter fusion;
    # a tracked landmark's id is unique among the tracked slots, so each
    # live row takes at most one add
    if tracked_prior_w is not None:
        tw = torch.where(tracked_valid, tracked_prior_w, 0.0)
        t_scat = torch.where(tw > 0, tracked_lm.to(torch.int64), l_cap)
        num = scatter(lm_prior * lm_prior_w[:, None], t_scat,
                      tw[:, None] * tracked_prior_pos, add=True)
        lm_prior_w = scatter(lm_prior_w, t_scat, tw, add=True)
        lm_prior = torch.where(
            (lm_prior_w > 0)[:, None],
            num / torch.clamp(lm_prior_w, min=1e-20)[:, None],
            lm_prior,
        )

    lm_prior = scatter(lm_prior, scat, new_p3)
    lm_prior_w = scatter(lm_prior_w, scat, new_prior_w)

    # tracked features bump their landmarks' refcounts
    trk_scat = torch.where(tracked_valid, tracked_lm.to(torch.int64), l_cap)
    lm_refcount = scatter(lm_refcount, trk_scat, torch.ones_like(tracked_lm), add=True)

    # this keyframe's packed observation row: tracked first, then new
    cat_uv = torch.cat([tracked_uv, new_uv], dim=0)
    cat_lm = torch.cat([tracked_lm, new_ids], dim=0)
    cat_valid = torch.cat([tracked_valid, new_valid], dim=0)
    order = valid_first(cat_valid)[:f_cap]
    row_valid, row_uv, row_lm = cat_valid[order], cat_uv[order], cat_lm[order]
    row_valid = row_valid & (torch.cumsum(row_valid.to(torch.int32), dim=0) <= cfg.max_features)

    # insert chronologically (oldest at index 0); a full window first evicts
    # the oldest keyframe. Both cases are computed and the device selects
    full = state.num_kf >= w_cap
    ev_scat = torch.where(state.obs_valid[0], state.obs_lm[0].to(torch.int64), l_cap)
    rc_ev = scatter(lm_refcount, ev_scat, -torch.ones_like(state.obs_lm[0]), add=True)
    lm_valid = torch.where(full, lm_valid & (rc_ev > 0), lm_valid)
    lm_refcount = torch.where(full, torch.clamp(rc_ev, min=0), lm_refcount)

    def shifted(t):
        return torch.where(full, torch.roll(t, -1, dims=0), t)

    idx = torch.where(full, w_cap - 1, torch.clamp(state.num_kf, max=w_cap - 1))
    row = torch.arange(w_cap, device=device) == idx
    poses = torch.where(row[:, None], pose[None, :], shifted(state.poses))
    obs_uv = torch.where(row[:, None, None], row_uv[None], shifted(state.obs_uv))
    obs_lm = torch.where(row[:, None], row_lm[None], shifted(state.obs_lm))
    obs_valid = torch.where(row[:, None], row_valid[None], shifted(state.obs_valid))
    pose_valid = state.pose_valid | row

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
    return torch.index_select(state.poses, 0, idx.reshape(1))[0]


def get_world_points(state: WindowState, ids: torch.Tensor) -> torch.Tensor:
    """Landmark id -> 3d position lookup."""
    return state.lm_pos[ids.to(torch.int64)]
