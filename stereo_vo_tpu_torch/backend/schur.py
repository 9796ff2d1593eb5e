"""Schur-complement Levenberg-Marquardt bundle adjustment (counterpart of
``stereo_vo_tpu/backend/schur.py::bundle_adjust`` on one device).

- The problem is landmark-major: observations pack as ``[L, W, ...]``, so
  every per-landmark block (V, g_l, the pose coupling W) is a dense reduction.
- Residuals carry Huber IRLS weights; each landmark carries a stereo prior.
- Landmarks are eliminated in closed form (3x3 adjugate inverses); the
  reduced camera system ``[W*6, W*6]`` is solved by LU with
  ``cfg.reduced_solve_refine`` iterative-refinement passes.
- Nielsen gain-ratio damping, the oldest pose held as gauge; exits on the
  relative tolerance, a flat rejected step, or saturated damping; the damping
  λ is warm-started across solves from ``WindowState.ba_lam``.
- The λ-free system is rebuilt only after an accepted step.

The LM loop runs in Python with one host sync per iteration (the accept test);
it executes iterations in pairs like the reference's unrolled loop, so the
iteration count matches it exactly.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from stereo_vo_tpu_torch.core.camera import CameraInfo
from stereo_vo_tpu_torch.core.config import BackendConfig
from stereo_vo_tpu_torch.core.geometry import (
    pose_q,
    pose_retract,
    pose_t,
    quat_lift_jacobian,
    rot_apply,
)
from stereo_vo_tpu_torch.backend.residuals import reprojection_jacobians, reprojection_residual
from stereo_vo_tpu_torch.backend.window import WindowState, valid_first


class BASolveStats(NamedTuple):
    initial_cost: torch.Tensor   # [] cost before the solve
    final_cost: torch.Tensor     # [] after
    iterations: torch.Tensor     # [] accepted LM steps
    converged: torch.Tensor      # [] bool: last relative decrease below tol


def _inv3x3(m: torch.Tensor, eps: float) -> torch.Tensor:
    """Batched closed-form (adjugate) inverse of ``[..., 3, 3]`` SPD blocks."""
    m = m + eps * torch.eye(3, dtype=m.dtype, device=m.device)
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    co_a = e * i - f * h
    co_b = -(d * i - f * g)
    co_c = d * h - e * g
    det = a * co_a + b * co_b + c * co_c
    inv_det = 1.0 / det
    adj = torch.stack(
        [
            co_a, -(b * i - c * h), b * f - c * e,
            co_b, a * i - c * g, -(a * f - c * d),
            co_c, -(a * h - b * g), a * e - b * d,
        ],
        dim=-1,
    ).reshape(m.shape)
    return adj * inv_det[..., None, None]


def _huber_weight(r: torch.Tensor, delta: float) -> torch.Tensor:
    """IRLS weight per observation for the Huber loss on ``|r|``; delta <= 0
    disables it."""
    if delta <= 0:
        return torch.ones(r.shape[:-1], dtype=r.dtype, device=r.device)
    norm = torch.sqrt(torch.sum(r * r, dim=-1) + 1e-12)
    # a filled numerator: torch's ``scalar / tensor`` rounds twice
    return torch.clamp(torch.full_like(norm, delta) / norm, max=1.0)


def _huber_rho(r: torch.Tensor, delta: float) -> torch.Tensor:
    sq = torch.sum(r * r, dim=-1)
    if delta <= 0:
        return 0.5 * sq
    norm = torch.sqrt(sq + 1e-12)
    return torch.where(norm <= delta, 0.5 * sq, delta * (norm - 0.5 * delta))


class LandmarkMajorProblem(NamedTuple):
    poses: torch.Tensor       # [W, 7]
    pose_valid: torch.Tensor  # [W]
    lm_pos: torch.Tensor      # [L, 3]
    lm_valid: torch.Tensor    # [L]
    obs_uv: torch.Tensor      # [L, W, 2]
    obs_valid: torch.Tensor   # [L, W]
    lm_prior: torch.Tensor    # [L, 3]
    lm_prior_w: torch.Tensor  # [L]


def window_to_landmark_major(window: WindowState) -> LandmarkMajorProblem:
    """Scatter the pose-major observations into landmark-major arrays."""
    lcap = window.landmark_capacity
    w, f = window.obs_valid.shape
    dev = window.obs_uv.device
    w_idx = torch.arange(w, device=dev)[:, None].expand(w, f)
    sel = window.obs_valid
    lm_idx = window.obs_lm[sel].to(torch.int64)
    obs_uv = torch.zeros((lcap, w, 2), dtype=window.obs_uv.dtype, device=dev)
    obs_uv[lm_idx, w_idx[sel]] = window.obs_uv[sel]
    obs_valid = torch.zeros((lcap, w), dtype=torch.bool, device=dev)
    obs_valid[lm_idx, w_idx[sel]] = True
    return LandmarkMajorProblem(
        poses=window.poses, pose_valid=window.pose_valid, lm_pos=window.lm_pos,
        lm_valid=window.lm_valid, obs_uv=obs_uv, obs_valid=obs_valid,
        lm_prior=window.lm_prior, lm_prior_w=window.lm_prior_w,
    )


def _obs_mask(poses, lm_pos, prob, min_depth):
    l, w = prob.obs_valid.shape
    pose_b = poses[None, :, :].expand(l, w, 7)
    pts = lm_pos[:, None, :].expand(l, w, 3)
    z = (rot_apply(pose_q(pose_b), pts) + pose_t(pose_b))[..., 2]
    mask = (
        prob.obs_valid
        & prob.pose_valid[None, :]
        & prob.lm_valid[:, None]
        & (z > min_depth)
    )
    return pose_b, pts, mask


def _lm_major_cost(poses, lm_pos, prob: LandmarkMajorProblem, cam, min_depth, huber_delta):
    pose_b, pts, mask = _obs_mask(poses, lm_pos, prob, min_depth)
    r = reprojection_residual(pose_b, pts, prob.obs_uv, cam)
    r = torch.where(mask[..., None], r, 0.0)
    cost = torch.sum(_huber_rho(r, huber_delta))
    dp = lm_pos - prob.lm_prior
    pw = torch.where(prob.lm_valid, prob.lm_prior_w, 0.0)
    return cost + 0.5 * torch.sum(pw[:, None] * dp * dp)


class BASystem(NamedTuple):
    """λ-free normal-equation blocks at one iterate."""

    v: torch.Tensor          # [L, 3, 3] landmark blocks (incl. prior)
    g_l: torch.Tensor        # [L, 3]
    wl: torch.Tensor         # [L, W, 6, 3] pose-landmark coupling
    u_blocks: torch.Tensor   # [W, 6, 6]
    g_p: torch.Tensor        # [W, 6]
    lm_active: torch.Tensor  # [L]
    free: torch.Tensor       # [W]


def _build_system(poses, lm_pos, prob: LandmarkMajorProblem, cam, cfg) -> BASystem:
    """Residuals and Jacobians at the iterate, accumulated into the λ-free
    blocks through one per-observation ``[10, 10]`` Gram of ``[jp6 | jl | r]``."""
    l, w = prob.obs_valid.shape
    dtype, dev = poses.dtype, poses.device
    pose_b, pts, mask = _obs_mask(poses, lm_pos, prob, cfg.min_depth)
    r, jp7, jl = reprojection_jacobians(pose_b, pts, prob.obs_uv, cam)
    r = torch.where(mask[..., None], r, 0.0)
    sw = torch.sqrt(_huber_weight(r, cfg.huber_delta_px))[..., None]
    r = r * sw
    lift = quat_lift_jacobian(poses[:, 0:4])                       # [W, 4, 3]
    jq = torch.sum(jp7[..., 0:4, None] * lift[None, :, None, :, :], dim=-2)
    jp6 = torch.cat([jq, jp7[..., 4:7]], dim=-1)
    jp6 = torch.where(mask[..., None, None], jp6 * sw[..., None], 0.0)
    jl = torch.where(mask[..., None, None], jl * sw[..., None], 0.0)

    jall = torch.cat([jp6, jl, r[..., None]], dim=-1)             # [L, W, 2, 10]
    gram = (
        jall[..., 0, :, None] * jall[..., 0, None, :]
        + jall[..., 1, :, None] * jall[..., 1, None, :]
    )                                                              # [L, W, 10, 10]
    v = torch.sum(gram[..., 6:9, 6:9], dim=1)
    g_l = -torch.sum(gram[..., 6:9, 9], dim=1)
    wl = gram[..., :6, 6:9]
    u_blocks = torch.sum(gram[..., :6, :6], dim=0)
    g_p = -torch.sum(gram[..., :6, 9], dim=0)

    pw = torch.where(prob.lm_valid, prob.lm_prior_w, 0.0)
    v = v + pw[:, None, None] * torch.eye(3, dtype=dtype, device=dev)
    g_l = g_l + pw[:, None] * (prob.lm_prior - lm_pos)

    lm_active = prob.lm_valid & (torch.diagonal(v, dim1=-2, dim2=-1).sum(-1) > 0)
    free = prob.pose_valid & (torch.arange(w, device=dev) > 0)
    return BASystem(v=v, g_l=g_l, wl=wl, u_blocks=u_blocks, g_p=g_p,
                    lm_active=lm_active, free=free)


def _damp(m: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    dd = lam * torch.clamp(torch.diagonal(m, dim1=-2, dim2=-1), 1e-8, 1e32)
    return m + torch.eye(m.shape[-1], dtype=m.dtype, device=m.device) * dd[..., None, :]


def _damp_reduce(sys: BASystem, lam: torch.Tensor):
    """λ-dependent half: damp, Schur-eliminate landmarks, gauge-fix.

    Returns ``(s [W,6,W,6], rhs [W,6], v_inv, dp_diag, dl_diag)``."""
    dtype, dev = sys.wl.dtype, sys.wl.device
    w = sys.u_blocks.shape[0]
    v_inv = _inv3x3(_damp(sys.v, lam), eps=1e-6)
    v_inv = torch.where(sys.lm_active[:, None, None], v_inv, 0.0)

    # one [31, 31] Gram against V^-1: -W V^-1 W^T and the rhs correction
    l = sys.wl.shape[0]
    n6 = w * 6
    wlg = torch.cat([sys.wl.reshape(l, n6, 3), sys.g_l[:, None, :]], dim=1)  # [L, 31, 3]
    a = torch.sum(wlg[:, :, :, None] * v_inv[:, None, :, :], dim=2)         # [L, 31, 3]
    msum = torch.einsum("lic,ljc->ij", a, wlg)                              # [31, 31]

    s = -msum[:n6, :n6].reshape(w, 6, w, 6)
    rhs = sys.g_p - msum[:n6, n6].reshape(w, 6)
    eye_w = torch.eye(w, dtype=dtype, device=dev)
    s = s + torch.einsum("wv,wab->wavb", eye_w, _damp(sys.u_blocks, lam))

    fm = sys.free.to(dtype)
    s = s * fm[:, None, None, None] * fm[None, None, :, None]
    s = s + torch.einsum("wv,ab->wavb", torch.diag(1.0 - fm),
                         torch.eye(6, dtype=dtype, device=dev))
    rhs = rhs * fm[:, None]
    dp_diag = torch.clamp(torch.diagonal(sys.u_blocks, dim1=-2, dim2=-1), 1e-8, 1e32)
    dl_diag = torch.clamp(torch.diagonal(sys.v, dim1=-2, dim2=-1), 1e-8, 1e32)
    return s, rhs, v_inv, dp_diag, dl_diag


def _solve_from_system(sys: BASystem, poses, lm_pos, lam, cfg):
    """Damped solve + back-substitution; returns ``(poses', lm_pos', pred)``
    with ``pred`` the decrease predicted by the damped quadratic model."""
    dtype, dev = poses.dtype, poses.device
    w = poses.shape[0]
    s, rhs, v_inv, dp_diag, dl_diag = _damp_reduce(sys, lam)
    fm = sys.free.to(dtype)

    n = w * 6
    s_mat = s.reshape(n, n) + 1e-10 * torch.eye(n, dtype=dtype, device=dev)
    rhs_v = rhs.reshape(n, 1)
    lu, piv = torch.linalg.lu_factor(s_mat)
    delta = torch.linalg.lu_solve(lu, piv, rhs_v)
    for _ in range(int(cfg.reduced_solve_refine)):
        resid = rhs_v - s_mat @ delta
        delta = delta + torch.linalg.lu_solve(lu, piv, resid)
    delta_p = delta.reshape(w, 6) * fm[:, None]

    wtdp = torch.sum(sys.wl * delta_p[None, :, :, None], dim=(1, 2))   # [L, 3]
    gw = sys.g_l - wtdp
    delta_l = torch.sum(v_inv * gw[:, None, :], dim=2)                 # [L, 3]
    delta_l = torch.where(sys.lm_active[:, None], delta_l, 0.0)

    pred_p = 0.5 * torch.sum(delta_p * (lam * dp_diag * delta_p + sys.g_p * fm[:, None]))
    pred_l = 0.5 * torch.sum(delta_l * (lam * dl_diag * delta_l + sys.g_l))
    pred = pred_p + pred_l

    new_poses = pose_retract(poses, delta_p)
    new_poses = torch.where(sys.free[:, None], new_poses, poses)
    return new_poses, lm_pos + delta_l, pred


def lm_loop(prob: LandmarkMajorProblem, cam, cfg, init_lam=None):
    """The LM accept/reject loop.

    Returns ``(poses, lm_pos, initial_cost, final_cost, accepted, last_rel,
    final_lam)``; ``init_lam`` overrides ``cfg.init_damping``."""
    poses, lm_pos = prob.poses, prob.lm_pos
    dtype, dev = poses.dtype, poses.device
    hd = cfg.huber_delta_px
    cost0 = _lm_major_cost(poses, lm_pos, prob, cam, cfg.min_depth, hd)
    sys = _build_system(poses, lm_pos, prob, cam, cfg)

    if init_lam is None:
        lam = torch.tensor(cfg.init_damping, dtype=dtype, device=dev)
    else:
        lam = torch.clamp(torch.as_tensor(init_lam, dtype=dtype, device=dev),
                          cfg.min_damping, cfg.max_damping)
    nu = torch.tensor(2.0, dtype=dtype, device=dev)
    cost = cost0
    accepted = 0
    rel = torch.tensor(0.0, dtype=dtype, device=dev)
    it = 0
    done = False
    tol = cfg.lm_rel_tol

    while it < cfg.max_lm_iters and not done:
        # two iterations per trip, as the reference's unrolled loop runs them
        for _ in range(2):
            if done:
                break
            cand_p, cand_l, pred = _solve_from_system(sys, poses, lm_pos, lam, cfg)
            cand_cost = _lm_major_cost(cand_p, cand_l, prob, cam, cfg.min_depth, hd)
            ok = bool((cand_cost < cost) & torch.isfinite(cand_cost))
            cost_prev = cost
            rho = (cost_prev - cand_cost) / torch.clamp(pred, min=1e-20)
            if ok:
                poses, lm_pos, cost = cand_p, cand_l, cand_cost
                sys = _build_system(poses, lm_pos, prob, cam, cfg)
                shrink = torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0)
                new_lam = torch.clamp(lam * shrink, cfg.min_damping, cfg.max_damping)
                nu = torch.full_like(nu, 2.0)
            else:
                new_lam = torch.clamp(lam * nu, cfg.min_damping, cfg.max_damping)
                nu = nu * 2.0
            rel = torch.abs(cost_prev - cost) / torch.clamp(cost_prev, min=1e-20)
            flat_reject = (not ok) and bool(
                torch.abs(cand_cost - cost_prev) < tol * torch.clamp(cost_prev, min=1e-20))
            done = ((ok and bool(rel < tol)) or flat_reject
                    or ((not ok) and bool(lam >= cfg.max_damping)))
            lam = new_lam
            accepted += int(ok)
            it += 1
    return (poses, lm_pos, cost0, cost,
            torch.tensor(accepted, dtype=torch.int32, device=dev), rel, lam)


def _bundle_adjust_uncompacted(window: WindowState, cam, cfg, rel_tol):
    prob = window_to_landmark_major(window)
    init_lam = window.ba_lam if (window.ba_lam is not None and cfg.lam_warm_start) else None
    poses, lm_pos, cost0, cost, accepted, last_rel, lam = lm_loop(
        prob, cam, cfg, init_lam=init_lam)
    new_window = window._replace(poses=poses, lm_pos=lm_pos)
    if window.ba_lam is not None:
        new_window = new_window._replace(ba_lam=lam.to(window.ba_lam.dtype))
    stats = BASolveStats(initial_cost=cost0, final_cost=cost, iterations=accepted,
                         converged=last_rel < rel_tol)
    return new_window, stats


def bundle_adjust(
    window: WindowState,
    cam: CameraInfo,
    cfg: BackendConfig,
    rel_tol: float = 1e-6,
) -> Tuple[WindowState, BASolveStats]:
    """Solve the sliding-window BA problem; writes optimized poses and
    landmarks back into the window.

    Live-landmark compaction (``cfg.ba_compact_landmarks``): when at most that
    many landmarks are live, solve on exactly that many rows (live first,
    stable order) and scatter positions back. Observations are masked by
    ``lm_valid[obs_lm]`` before the remap, so no observation can alias a
    dead landmark."""
    if cfg.reduced_solve_f64:
        raise NotImplementedError(
            "reduced_solve_f64 (the f64 island) is not ported yet (ROADMAP Queue 1, item 18)")
    lcap = window.landmark_capacity
    l_small = cfg.ba_compact_landmarks
    if 0 < l_small < lcap and int(window.lm_valid.sum()) <= l_small:
        order = valid_first(window.lm_valid)[:l_small]
        inv = torch.zeros((lcap,), dtype=torch.int64, device=order.device)
        inv[order] = torch.arange(l_small, device=order.device)
        obs_lm = window.obs_lm.to(torch.int64)
        obs_ok = window.obs_valid & window.lm_valid[obs_lm]
        small = window._replace(
            obs_lm=torch.where(obs_ok, inv[obs_lm], 0).to(torch.int32),
            obs_valid=obs_ok,
            lm_pos=window.lm_pos[order],
            lm_refcount=window.lm_refcount[order],
            lm_valid=window.lm_valid[order],
            lm_prior=window.lm_prior[order],
            lm_prior_w=window.lm_prior_w[order],
        )
        out, stats = _bundle_adjust_uncompacted(small, cam, cfg, rel_tol)
        lm_pos = window.lm_pos.clone()
        lm_pos[order] = out.lm_pos
        merged = window._replace(poses=out.poses, lm_pos=lm_pos)
        if window.ba_lam is not None:
            merged = merged._replace(ba_lam=out.ba_lam)
        return merged, stats
    return _bundle_adjust_uncompacted(window, cam, cfg, rel_tol)
