"""Schur-complement Levenberg-Marquardt bundle adjustment (counterpart of
``stereo_vo_tpu/backend/schur.py::bundle_adjust`` on one device).

- The problem is landmark-major: observations pack as ``[L, W, ...]``, so
  every per-landmark block (V, g_l, the pose coupling W) is a dense reduction.
- Residuals carry Huber IRLS weights; each landmark carries a stereo prior.
- Landmarks are eliminated in closed form (3x3 adjugate inverses); the
  reduced camera system ``[W*6, W*6]`` is solved by LU with
  ``cfg.reduced_solve_refine`` iterative-refinement passes, or, with
  ``cfg.reduced_solve_f64``, promoted to float64 and solved once (the f64
  island). The reference honours that flag only when ``jax_enable_x64`` is
  on and otherwise silently takes the f32 path; torch has float64 on every
  device, so the port honours it whenever it is set.
- Nielsen gain-ratio damping, the oldest pose held as gauge; exits on the
  relative tolerance, a flat rejected step, or saturated damping; the damping
  λ is warm-started across solves from ``WindowState.ba_lam``.
- The λ-free system is kept from the last accepted step.

The LM loop is the reference's ``while_loop`` over pairs of bodies, with its
conditional rebuild (``lm_loop``): ``engine/graphs.py``'s ``while_loop`` and
``cond``, which read their predicates on the host outside a capture and are
a WHILE node and IF pairs in the card's step graph. Inside a body every
other decision is taken on the device. The choice between the compacted and
the full solve is the caller's (``bundle_adjust(compact=...)``) or one host
read.

On the card a body is the hand kernels of ``csrc/ba_lm.cu`` around the
reduced LU solve: ``ba_damp_reduce`` (the damped Schur reduction to ``s``
and ``rhs``), the LU's library calls, ``ba_step`` (back-substitution,
retraction, the candidate's cost and the accept / damping update), and
``ba_build`` (the λ-free system) in the rebuild; ``ba_cost`` gives the
initial cost. Each wrapper takes its plain version, the torch functions of
this module, for CPU tensors: ``_build_system``, ``_reduced_system``,
``_ba_step_ref`` and ``_lm_major_cost_ref``.

Landmark sharding (``parallel/sharded_ba.py``): given a process group, each
rank holds a contiguous block of landmarks and ``lm_loop`` all-reduces (sum)
at the reference's ``psum`` points: the cost, the pose blocks ``u_blocks``
and ``g_p`` of each build, the ``[6W+1, 6W+1]`` Schur block of each damped
reduction, and the landmark half of the predicted decrease. Every rank runs
the same trips on the same reduced numbers, so the ranks stay in lockstep.
Without a group nothing changes.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from vobench.reference.core.camera import CameraInfo
from vobench.reference.core.config import BackendConfig
from vobench.reference.core.f32 import fma_f32, sqrt_f32
from vobench.reference.core.geometry import (
    pose_q,
    pose_retract,
    pose_t,
    quat_lift_jacobian,
    rot_apply,
)
from vobench.reference.backend.residuals import reprojection_jacobians, reprojection_residual
from vobench.reference.backend.window import WindowState, valid_first


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
    norm = sqrt_f32(torch.sum(r * r, dim=-1) + 1e-12)
    # a filled numerator: torch's ``scalar / tensor`` rounds twice
    return torch.clamp(torch.full_like(norm, delta) / norm, max=1.0)


def _huber_rho(r: torch.Tensor, delta: float) -> torch.Tensor:
    sq = torch.sum(r * r, dim=-1)
    if delta <= 0:
        return 0.5 * sq
    norm = sqrt_f32(sq + 1e-12)
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
    """Scatter the pose-major observations into landmark-major arrays, at
    fixed shapes: invalid observations go to a dump row past the last
    landmark, which is cut off (the reference's ``mode="drop"``)."""
    lcap = window.landmark_capacity
    w, f = window.obs_valid.shape
    dev = window.obs_uv.device
    w_idx = torch.arange(w, device=dev)[:, None].expand(w, f)
    lm_idx = torch.where(window.obs_valid, window.obs_lm.to(torch.int64), lcap)
    obs_uv = torch.zeros((lcap + 1, w, 2), dtype=window.obs_uv.dtype, device=dev)
    obs_uv[lm_idx, w_idx] = window.obs_uv
    obs_valid = torch.zeros((lcap + 1, w), dtype=torch.bool, device=dev)
    # a tensor value: a Python scalar here would be a host-to-device copy
    obs_valid[lm_idx, w_idx] = window.obs_valid
    return LandmarkMajorProblem(
        poses=window.poses, pose_valid=window.pose_valid, lm_pos=window.lm_pos,
        lm_valid=window.lm_valid, obs_uv=obs_uv[:lcap], obs_valid=obs_valid[:lcap],
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


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over the ranks of ``group`` (the reference's ``psum``)."""
    t = t.contiguous()
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def _lm_major_cost_ref(poses, lm_pos, prob: LandmarkMajorProblem, cam, min_depth, huber_delta,
                       group=None):
    """The Huber cost plus the stereo prior at an iterate: the plain version
    of ``ba_cost``."""
    pose_b, pts, mask = _obs_mask(poses, lm_pos, prob, min_depth)
    r = reprojection_residual(pose_b, pts, prob.obs_uv, cam)
    r = torch.where(mask[..., None], r, 0.0)
    cost = torch.sum(_huber_rho(r, huber_delta))
    dp = lm_pos - prob.lm_prior
    pw = torch.where(prob.lm_valid, prob.lm_prior_w, 0.0)
    cost = cost + 0.5 * torch.sum(pw[:, None] * dp * dp)
    return cost if group is None else _all_reduce(cost, group)


class BASystem(NamedTuple):
    """λ-free normal-equation blocks at one iterate."""

    v: torch.Tensor          # [L, 3, 3] landmark blocks (incl. prior)
    g_l: torch.Tensor        # [L, 3]
    wl: torch.Tensor         # [L, W, 6, 3] pose-landmark coupling
    u_blocks: torch.Tensor   # [W, 6, 6]
    g_p: torch.Tensor        # [W, 6]
    lm_active: torch.Tensor  # [L]
    free: torch.Tensor       # [W]


def _build_system(poses, lm_pos, prob: LandmarkMajorProblem, cam, cfg, group=None) -> BASystem:
    """Residuals and Jacobians at the iterate, accumulated into the λ-free
    blocks through one per-observation ``[10, 10]`` Gram of ``[jp6 | jl | r]``."""
    l, w = prob.obs_valid.shape
    dtype, dev = poses.dtype, poses.device
    pose_b, pts, mask = _obs_mask(poses, lm_pos, prob, cfg.min_depth)
    r, jp7, jl = reprojection_jacobians(pose_b, pts, prob.obs_uv, cam)
    r = torch.where(mask[..., None], r, 0.0)
    sw = sqrt_f32(_huber_weight(r, cfg.huber_delta_px))[..., None]
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
    if group is not None:
        u_blocks, g_p = _all_reduce(u_blocks, group), _all_reduce(g_p, group)

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


def _damp_reduce(sys: BASystem, lam: torch.Tensor, group=None):
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
    if group is not None:
        msum = _all_reduce(msum, group)

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


def reduced_camera_condition(prob: LandmarkMajorProblem, cam, cfg, lam: float = 0.0
                             ) -> torch.Tensor:
    """2-norm condition number of the damped, gauge-fixed reduced camera
    system ``[6W, 6W]`` that the solver sees at ``prob``'s iterate: an f32
    solve loses about ``log10(cond)`` digits, so a large value asks for
    ``reduced_solve_refine`` or ``reduced_solve_f64``.

    A diagnostic, called once and outside the step: it runs the plain
    versions on every device, since it wants ``_damp_reduce``'s ``s`` without
    the solve's ``1e-10 I`` that ``ba_damp_reduce`` adds."""
    dtype = prob.poses.dtype
    sys = _build_system(prob.poses, prob.lm_pos, prob, cam, cfg)
    s = _damp_reduce(sys, torch.tensor(lam, dtype=dtype, device=prob.poses.device))[0]
    n = prob.poses.shape[0] * 6
    sv = torch.linalg.svdvals(s.reshape(n, n))
    return sv[0] / torch.clamp(sv[-1], min=torch.finfo(dtype).tiny)


def _reduced_system(sys: BASystem, lam: torch.Tensor, group=None):
    """The reduced camera system as the solve takes it: ``(s [6W, 6W] + 1e-10
    I, rhs [6W, 1], v_inv [L, 3, 3])``; the plain version of
    ``ba_damp_reduce``."""
    s, rhs, v_inv, _, _ = _damp_reduce(sys, lam, group)
    n = s.shape[0] * 6
    s_mat = s.reshape(n, n) + 1e-10 * torch.eye(n, dtype=s.dtype, device=s.device)
    return s_mat, rhs.reshape(n, 1), v_inv


def _reduced_solve(s_mat, rhs_v, resid, cfg):
    """LU with ``cfg.reduced_solve_refine`` refinement passes, or the f64
    island: ``(delta, corr)``, the solution ``delta + corr`` (``corr`` None
    without refinement). ``resid``, where given, holds a copy of ``rhs_v``
    that the first pass's residual is formed in, in place (one library call
    on the card)."""
    if cfg.reduced_solve_f64:
        # the f64 island: Ceres' double-precision dense Schur solve, for the
        # tiny reduced system only
        return torch.linalg.solve_ex(s_mat.to(torch.float64),
                                     rhs_v.to(torch.float64))[0].to(s_mat.dtype), None
    lu, piv, _ = torch.linalg.lu_factor_ex(s_mat)
    delta = torch.linalg.lu_solve(lu, piv, rhs_v)
    corr = None
    for _ in range(int(cfg.reduced_solve_refine)):
        if corr is not None:
            delta = delta + corr
        if resid is None:
            resid = rhs_v - s_mat @ delta
        else:
            resid.addmm_(s_mat, delta, alpha=-1.0)
        corr = torch.linalg.lu_solve(lu, piv, resid)
        resid = None
    return delta, corr


def _back_substitute(sys: BASystem, v_inv, delta, poses, lm_pos, lam, group=None):
    """The landmarks' back-substitution from the reduced solve's ``delta [6W,
    1]`` and the retraction: ``(poses', lm_pos', pred)`` with ``pred`` the
    decrease predicted by the damped quadratic model."""
    dtype = poses.dtype
    w = poses.shape[0]
    fm = sys.free.to(dtype)
    delta_p = delta.reshape(w, 6) * fm[:, None]

    wtdp = torch.sum(sys.wl * delta_p[None, :, :, None], dim=(1, 2))   # [L, 3]
    gw = sys.g_l - wtdp
    delta_l = torch.sum(v_inv * gw[:, None, :], dim=2)                 # [L, 3]
    delta_l = torch.where(sys.lm_active[:, None], delta_l, 0.0)

    dp_diag = torch.clamp(torch.diagonal(sys.u_blocks, dim1=-2, dim2=-1), 1e-8, 1e32)
    dl_diag = torch.clamp(torch.diagonal(sys.v, dim1=-2, dim2=-1), 1e-8, 1e32)
    pred_p = 0.5 * torch.sum(delta_p * (lam * dp_diag * delta_p + sys.g_p * fm[:, None]))
    pred_l = 0.5 * torch.sum(delta_l * (lam * dl_diag * delta_l + sys.g_l))
    if group is not None:
        pred_l = _all_reduce(pred_l, group)
    pred = pred_p + pred_l

    new_poses = pose_retract(poses, delta_p)
    new_poses = torch.where(sys.free[:, None], new_poses, poses)
    return new_poses, lm_pos + delta_l, pred


def _solve_from_system(sys: BASystem, poses, lm_pos, lam, cfg, group=None):
    """Damped solve + back-substitution; returns ``(poses', lm_pos', pred)``
    with ``pred`` the decrease predicted by the damped quadratic model."""
    s_mat, rhs_v, v_inv = _reduced_system(sys, lam, group)
    delta, corr = _reduced_solve(s_mat, rhs_v, None, cfg)
    if corr is not None:
        delta = delta + corr
    return _back_substitute(sys, v_inv, delta, poses, lm_pos, lam, group)


def lm_trip(max_lm_iters: int) -> int:
    """The most loop bodies ``lm_loop`` runs: the reference's ``while_loop``
    runs pairs of bodies while fewer than ``max_lm_iters`` have updated, so
    at most ``2 * ceil(max_lm_iters / 2)``."""
    return 2 * ((max_lm_iters + 1) // 2)


class _LMCarry(NamedTuple):
    """The reference's ``while_loop`` carry."""

    poses: torch.Tensor
    lm_pos: torch.Tensor
    sys: BASystem
    lam: torch.Tensor
    nu: torch.Tensor
    cost: torch.Tensor
    accepted: torch.Tensor   # [] int32 accepted steps
    it: torch.Tensor         # [] int32 bodies that updated
    rel: torch.Tensor
    done: torch.Tensor       # [] bool


class _LMStep(NamedTuple):
    """What one body hands on: the accept flag and the new carry, its
    system aside."""

    ok: torch.Tensor         # [] bool
    poses: torch.Tensor
    lm_pos: torch.Tensor
    lam: torch.Tensor
    nu: torch.Tensor
    cost: torch.Tensor
    accepted: torch.Tensor
    it: torch.Tensor
    rel: torch.Tensor
    done: torch.Tensor


def _lm_update(c: _LMCarry, cand_p, cand_l, cand_cost, pred, cfg) -> _LMStep:
    """The body's bookkeeping: the accept test on the candidate's cost, the
    Nielsen damping update and the stops."""
    tol = cfg.lm_rel_tol
    cost, lam, nu = c.cost, c.lam, c.nu
    upd = ~c.done
    ok = (cand_cost < cost) & torch.isfinite(cand_cost) & upd
    poses = torch.where(ok, cand_p, c.poses)
    lm_pos = torch.where(ok, cand_l, c.lm_pos)
    cost_new = torch.where(ok, cand_cost, cost)
    rho = (cost - cand_cost) / torch.clamp(pred, min=1e-20)
    # 1 - b^3 rounded as the reference's compiled code rounds it: one fused
    # multiply-add of -(b * b) and b
    b = 2.0 * rho - 1.0
    shrink = torch.clamp(fma_f32(-(b * b), b, 1.0), min=1.0 / 3.0)
    new_lam = torch.where(
        upd,
        torch.clamp(torch.where(ok, lam * shrink, lam * nu), cfg.min_damping, cfg.max_damping),
        lam)
    nu = torch.where(upd, torch.where(ok, torch.full_like(nu, 2.0), nu * 2.0), nu)
    rel = torch.where(upd, torch.abs(cost - cost_new) / torch.clamp(cost, min=1e-20), c.rel)
    flat_reject = upd & ~ok & (torch.abs(cand_cost - cost) < tol * torch.clamp(cost, min=1e-20))
    done = c.done | (ok & (rel < tol)) | flat_reject | (upd & ~ok & (lam >= cfg.max_damping))
    return _LMStep(ok, poses, lm_pos, new_lam, nu, cost_new, c.accepted + ok.to(torch.int32),
                   c.it + upd.to(torch.int32), rel, done)


def _ba_step_ref(c: _LMCarry, v_inv, delta, corr, prob: LandmarkMajorProblem, cam, cfg,
                 group=None) -> _LMStep:
    """A body after its reduced solve: back-substitution from ``delta +
    corr``, the candidate's cost and the update; the plain version of
    ``ba_step``."""
    if corr is not None:
        delta = delta + corr
    cand_p, cand_l, pred = _back_substitute(c.sys, v_inv, delta, c.poses, c.lm_pos, c.lam, group)
    cand_cost = _lm_major_cost_ref(cand_p, cand_l, prob, cam, cfg.min_depth, cfg.huber_delta_px,
                                   group)
    return _lm_update(c, cand_p, cand_l, cand_cost, pred, cfg)


# ---------------------------------------------------------------------------
def ba_build(poses, lm_pos, prob: LandmarkMajorProblem, cam, cfg, group=None) -> BASystem:
    return _build_system(poses, lm_pos, prob, cam, cfg, group)


def ba_damp_reduce(sys: BASystem, lam: torch.Tensor, cfg, group=None):
    return (*_reduced_system(sys, lam, group), None)


def ba_step(c: _LMCarry, v_inv, delta, corr, prob: LandmarkMajorProblem, cam, cfg,
            group=None) -> _LMStep:
    return _ba_step_ref(c, v_inv, delta, corr, prob, cam, cfg, group)


def ba_cost(poses, lm_pos, prob: LandmarkMajorProblem, cam, min_depth, huber_delta,
            group=None) -> torch.Tensor:
    return _lm_major_cost_ref(poses, lm_pos, prob, cam, min_depth, huber_delta, group)


# the reference's name for the cost at an iterate
_lm_major_cost = ba_cost


def lm_loop(prob: LandmarkMajorProblem, cam, cfg, init_lam=None, group=None):
    """The LM accept/reject loop (``_lm_run`` without its iteration count).

    Returns ``(poses, lm_pos, initial_cost, final_cost, accepted, last_rel,
    final_lam)``; ``init_lam`` overrides ``cfg.init_damping``. With a
    process ``group``, ``prob`` holds this rank's landmark block and the
    reductions are summed over the group (module docstring); the returned
    ``lm_pos`` is the local block.

    The reference's loop: ``engine/graphs.py::while_loop`` over pairs of
    bodies while fewer than ``cfg.max_lm_iters`` bodies have updated and
    the solve is not ``done`` (odd ``max_lm_iters`` included), the second
    body of a pair a no-op once ``done`` (``upd = ~done`` freezes the
    carry). Each body rebuilds the λ-free system only after an accepted
    step (``graphs.cond``), and a rejected step re-solves the carried one at
    the raised damping. On the CPU each predicate is read on the host; in
    the card's step graph the loop is a WHILE node and the rebuild an IF
    pair, with no host read. With a ``group`` (never captured) the system
    is rebuilt every body and kept only after an accepted step, as the
    reference's sharded solver does; the loop's predicate comes from
    all-reduced values, so every rank takes the same trips."""
    return _lm_run(prob, cam, cfg, init_lam, group)[:7]


def _lm_run(prob: LandmarkMajorProblem, cam, cfg, init_lam=None, group=None):
    """``lm_loop``'s results and, last, the bodies that updated (the
    reference's ``it``)."""
    # engine/__init__ imports this module's users, so the engine's graphs
    # come late
    from vobench.reference.engine import graphs

    poses, lm_pos = prob.poses, prob.lm_pos
    dtype, dev = poses.dtype, poses.device
    cost0 = _lm_major_cost(poses, lm_pos, prob, cam, cfg.min_depth, cfg.huber_delta_px, group)
    sys0 = ba_build(poses, lm_pos, prob, cam, cfg, group)

    if init_lam is None:
        lam = torch.full((), cfg.init_damping, dtype=dtype, device=dev)
    else:
        lam = torch.clamp(torch.as_tensor(init_lam, dtype=dtype, device=dev),
                          cfg.min_damping, cfg.max_damping)

    def rebuild(p, l, _):
        return ba_build(p, l, prob, cam, cfg)

    def keep(_, __, sys):
        return sys

    def body(c: _LMCarry) -> _LMCarry:
        s_mat, rhs_v, v_inv, resid = ba_damp_reduce(c.sys, c.lam, cfg, group)
        delta, corr = _reduced_solve(s_mat, rhs_v, resid, cfg)
        step = ba_step(c, v_inv, delta, corr, prob, cam, cfg, group)
        if group is None:
            sys = graphs.cond(step.ok, rebuild, keep, (step.poses, step.lm_pos, c.sys))
        else:
            rebuilt = ba_build(step.poses, step.lm_pos, prob, cam, cfg, group)
            sys = BASystem(*(torch.where(step.ok, new, old) for new, old in zip(rebuilt, c.sys)))
        return _LMCarry(step.poses, step.lm_pos, sys, step.lam, step.nu, step.cost,
                        step.accepted, step.it, step.rel, step.done)

    def lm_pair(c: _LMCarry) -> _LMCarry:
        return body(body(c))

    def running(c: _LMCarry) -> torch.Tensor:
        return (c.it < cfg.max_lm_iters) & ~c.done

    zero_i = torch.zeros((), dtype=torch.int32, device=dev)
    c = graphs.while_loop(running, lm_pair, _LMCarry(
        poses, lm_pos, sys0, lam, torch.full((), 2.0, dtype=dtype, device=dev), cost0, zero_i,
        zero_i, torch.zeros((), dtype=dtype, device=dev),
        torch.zeros((), dtype=torch.bool, device=dev)))
    return c.poses, c.lm_pos, cost0, c.cost, c.accepted, c.rel, c.lam, c.it


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


def compaction_applies(cfg: BackendConfig, landmark_capacity: int) -> bool:
    """Whether ``bundle_adjust`` chooses between a compacted and a full solve."""
    return 0 < cfg.ba_compact_landmarks < landmark_capacity


def bundle_adjust(
    window: WindowState,
    cam: CameraInfo,
    cfg: BackendConfig,
    rel_tol: float = 1e-6,
    compact=None,
) -> Tuple[WindowState, BASolveStats]:
    """Solve the sliding-window BA problem; writes optimized poses and
    landmarks back into the window.

    Live-landmark compaction (``cfg.ba_compact_landmarks``): when at most that
    many landmarks are live, solve on exactly that many rows (live first,
    stable order) and scatter positions back. Observations are masked by
    ``lm_valid[obs_lm]`` before the remap, so no observation can alias a
    dead landmark.

    ``compact`` is the reference's choice between the two solves (its
    ``lax.cond`` on the live count): ``None`` reads the live count from the
    window (one host read); ``True`` or ``False`` takes that solve, which
    then reads nothing back. The two sum in different float32 orders."""
    lcap = window.landmark_capacity
    l_small = cfg.ba_compact_landmarks
    if not compaction_applies(cfg, lcap):
        compact = False
    elif compact is None:
        compact = int(window.lm_valid.sum()) <= l_small
    if compact:
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
