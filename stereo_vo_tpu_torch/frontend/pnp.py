"""PnP-RANSAC: camera pose from 2D-3D correspondences (counterpart of
``stereo_vo_tpu/frontend/pnp.py::pnp_ransac``).

- a fixed hypothesis count (``cfg.pnp_iterations``); hypothesis 0 is the warm
  start from the previous pose, polished by trimmed Gauss-Newton on all points;
- minimal solver: 6-point DLT on K-normalized rays (null vector by Householder
  QR + inverse iteration), orthogonalized by Newton polar iteration,
  polished by damped GN on the sample;
- inlier = reprojection error < threshold (pixels) and positive depth; the
  first hypothesis with the most inliers wins;
- LO-RANSAC rounds refine on the inlier set and keep a round only if it does
  not lose inliers.

The seam between sampling and solving: ``pnp_ransac_core`` takes the
hypothesis sample indices ``[n_hyp - 1, k]`` as input. ``pnp_ransac`` draws
them with ``sample_hypotheses``, which recomputes the reference's
``jax.random`` draw bit for bit from the frame index (``frontend/prng.py``),
so both packages solve the same hypotheses; ``hyp_idx`` still lets a caller
inject its own.

On the card the minimal solver and its polish, for every hypothesis, are one
hand kernel (``pnp_hypotheses``, ``csrc/pnp_hyp.cu``); ``pnp_hypotheses_ref``
is its plain version, which the CPU runs.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from stereo_vo_tpu_torch.core.camera import CameraInfo
from stereo_vo_tpu_torch.core.config import FrontendConfig
from stereo_vo_tpu_torch.core.f32 import sqrt_f32
from stereo_vo_tpu_torch.core.geometry import (
    make_pose,
    pose_apply,
    pose_q,
    pose_retract,
    quat_lift_jacobian,
    rotmat_to_quat,
)
from stereo_vo_tpu_torch.backend.residuals import reprojection_jacobians
from stereo_vo_tpu_torch.frontend import prng


def _inv3(m: torch.Tensor) -> torch.Tensor:
    """Closed-form batched 3x3 inverse."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    co_a = e * i - f * h
    co_b = -(d * i - f * g)
    co_c = d * h - e * g
    det = a * co_a + b * co_b + c * co_c
    adj = torch.stack(
        [co_a, -(b * i - c * h), b * f - c * e,
         co_b, a * i - c * g, -(a * f - c * d),
         co_c, -(a * h - b * g), a * e - b * d], dim=-1
    ).reshape(m.shape)
    return adj / det[..., None, None]


def _polar_so3(m: torch.Tensor, iters: int = 8):
    """Project batched 3x3 matrices to SO(3)-scaled form by Newton polar
    iteration ``R <- (R + R^-T)/2``; returns ``(R, scale)`` with ``scale`` the
    signed mean singular value."""
    norm = sqrt_f32(torch.sum(m * m, dim=(-2, -1), keepdim=True) / 3.0)
    r = m / torch.clamp(norm, min=1e-20)
    for _ in range(iters):
        r = 0.5 * (r + _inv3(r).transpose(-1, -2))
    s = torch.einsum("...ji,...jk->...ik", r, m)
    scale = torch.diagonal(s, dim1=-2, dim2=-1).sum(-1) / 3.0
    return r, scale


def _nullvec_qr(a: torch.Tensor) -> torch.Tensor:
    """Right null vector of batched square ``a [..., n, n]``: Householder QR of
    ``a^T``, two inverse-iteration steps on ``R R^T`` by triangular solves,
    then ``v = Q z`` through the stored reflectors."""
    n = a.shape[-1]
    b = a.transpose(-1, -2).clone()
    vs = []
    for k in range(n - 1):
        x = b[..., k:, k]
        alpha = sqrt_f32(torch.sum(x * x, dim=-1))
        sign = torch.where(x[..., 0] >= 0, 1.0, -1.0).to(a.dtype)
        v = x.clone()
        v[..., 0] = v[..., 0] + sign * alpha
        vn = sqrt_f32(torch.sum(v * v, dim=-1, keepdim=True))
        v = v / torch.clamp(vn, min=1e-30)
        sub = b[..., k:, k:]
        w = torch.einsum("...i,...ij->...j", v, sub)
        b = b.clone()
        b[..., k:, k:] = sub - 2.0 * v[..., :, None] * w[..., None, :]
        vs.append(v)
    r = b

    # guard exactly-zero diagonals with a ridge relative to the matrix scale
    scale = sqrt_f32(torch.sum(a * a, dim=(-2, -1)) / (n * n))
    diag = torch.diagonal(r, dim1=-2, dim2=-1)
    eps = (1e-12 * scale)[..., None]
    diag = torch.where(torch.abs(diag) > eps, diag,
                       torch.where(diag >= 0, 1.0, -1.0).to(a.dtype) * eps)

    def back_sub(z):       # solve R y = z
        y = [None] * n
        for i in range(n - 1, -1, -1):
            acc = z[..., i]
            for j in range(i + 1, n):
                acc = acc - r[..., i, j] * y[j]
            y[i] = acc / diag[..., i]
        return torch.stack(y, dim=-1)

    def fwd_sub(z):        # solve R^T y = z
        y = [None] * n
        for i in range(n):
            acc = z[..., i]
            for j in range(i):
                acc = acc - r[..., j, i] * y[j]
            y[i] = acc / diag[..., i]
        return torch.stack(y, dim=-1)

    z = torch.zeros(a.shape[:-2] + (n,), dtype=a.dtype, device=a.device)
    z[..., n - 1] = 1.0
    for _ in range(2):
        z = fwd_sub(back_sub(z))
        z = z / torch.clamp(sqrt_f32(torch.sum(z * z, dim=-1, keepdim=True)), min=1e-30)
    for k in range(n - 2, -1, -1):
        v = vs[k]
        zk = z[..., k:]
        coef = torch.sum(v * zk, dim=-1, keepdim=True)
        z = torch.cat([z[..., :k], zk - 2.0 * v * coef], dim=-1)
    return z


class PnPResult(NamedTuple):
    pose: torch.Tensor         # [7] T_cw
    inliers: torch.Tensor      # [F] bool
    num_inliers: torch.Tensor  # []
    ok: torch.Tensor           # [] bool: enough inliers to trust the pose


def _dlt_pose(p3: torch.Tensor, xn: torch.Tensor):
    """Batched 6-point DLT: world points ``[H, 6, 3]`` + normalized image
    coordinates ``[H, 6, 2]`` -> ``(R [H, 3, 3], t [H, 3], ok [H])``."""
    c = torch.mean(p3, dim=-2)                                          # [H, 3]
    s = sqrt_f32(torch.mean(torch.sum((p3 - c[..., None, :]) ** 2, dim=-1), dim=-1) / 3.0)
    s = torch.clamp(s, min=1e-6)
    pn = (p3 - c[..., None, :]) / s[..., None, None]
    ones = torch.ones(p3.shape[:-1] + (1,), dtype=p3.dtype, device=p3.device)
    zeros = torch.zeros(p3.shape[:-1] + (4,), dtype=p3.dtype, device=p3.device)
    ph = torch.cat([pn, ones], dim=-1)                                  # [H, 6, 4]
    rows_x = torch.cat([ph, zeros, -xn[..., 0:1] * ph], dim=-1)
    rows_y = torch.cat([zeros, ph, -xn[..., 1:2] * ph], dim=-1)
    a = torch.cat([rows_x, rows_y], dim=-2)                             # [H, 12, 12]
    mn = _nullvec_qr(a).reshape(a.shape[:-2] + (3, 4))
    # denormalize: P = M_n @ [[I/s, -c/s], [0, 1]]
    rot_part = mn[..., :3]
    t_part = mn[..., 3] - torch.einsum("...ij,...j->...i", rot_part, c) / s[..., None]
    m = torch.cat([rot_part / s[..., None, None], t_part[..., None]], dim=-1)

    def fix(mm):
        r, scale = _polar_so3(mm[..., :3])
        flip = torch.sign(torch.linalg.det(r))
        r = r * flip[..., None, None]
        scale = scale * flip
        t = mm[..., 3] / torch.where(torch.abs(scale) > 1e-12, scale, 1e-12)[..., None]
        z = (torch.einsum("...nj,...ij->...ni", p3, r) + t[..., None, :])[..., 2]
        return r, t, torch.sum(z > 0, dim=-1), torch.abs(scale) > 1e-9

    r_a, t_a, npos_a, ok_a = fix(m)
    r_b, t_b, npos_b, ok_b = fix(-m)
    pick_a = npos_a >= npos_b
    r = torch.where(pick_a[..., None, None], r_a, r_b)
    t = torch.where(pick_a[..., None], t_a, t_b)
    ok = torch.where(pick_a, ok_a, ok_b)
    return r, t, ok


def _reproj_errors(pose: torch.Tensor, p3: torch.Tensor, uv: torch.Tensor,
                   cam: CameraInfo) -> torch.Tensor:
    """Pixel reprojection error of ``p3 [F, 3]`` under ``pose [..., 7]``;
    inf behind the camera."""
    p_cam = pose_apply(pose[..., None, :], p3)
    z = p_cam[..., 2]
    safe_z = torch.where(z > 1e-6, z, 1.0)
    proj = p_cam[..., :2] / safe_z[..., None] * cam.focal + cam.principal_point(p3)
    d = proj - uv
    err = sqrt_f32(torch.sum(d * d, dim=-1))
    return torch.where(z > 1e-6, err, float("inf"))


def _gn_refine(pose, p3, uv, weight, cam, iters: int):
    """Damped Gauss-Newton on the weighted reprojection cost (pose only),
    batched over leading dims of ``pose [..., 7]`` / ``p3 [..., F, 3]``."""
    eye = 1e-6 * torch.eye(6, dtype=pose.dtype, device=pose.device)
    for _ in range(iters):
        pose_b = pose[..., None, :].expand(p3.shape[:-1] + (7,))
        r, jp7, _ = reprojection_jacobians(pose_b, p3, uv, cam)
        lift = quat_lift_jacobian(pose_q(pose))                    # [..., 4, 3]
        jq = torch.einsum("...fij,...jk->...fik", jp7[..., 0:4], lift)
        j6 = torch.cat([jq, jp7[..., 4:7]], dim=-1)                # [..., F, 2, 6]
        r = torch.where(weight[..., None], r, 0.0)
        j6 = torch.where(weight[..., None, None], j6, 0.0)
        r = torch.nan_to_num(r)
        j6 = torch.nan_to_num(j6)
        h = torch.einsum("...fri,...frj->...ij", j6, j6) + eye
        g = -torch.einsum("...fri,...fr->...i", j6, r)
        delta = torch.linalg.solve_ex(h, g)[0]
        pose = pose_retract(pose, delta)
    return pose


def _all_finite(x: torch.Tensor) -> torch.Tensor:
    return torch.all(torch.isfinite(x), dim=-1)


def pnp_hypotheses_ref(p3: torch.Tensor, uv: torch.Tensor, hyp_idx: torch.Tensor,
                       cam: CameraInfo, polish_iters: int):
    """The hypothesis stage as torch ops: for each minimal sample
    ``hyp_idx [H, k]`` of ``p3 [F, 3]`` and ``uv [F, 2]``, the DLT pose on
    its K-normalized rays, polished by ``polish_iters`` damped GN steps on
    the sample; returns ``(hyp [H, 7], hyp_ok [H])``."""
    xn = (uv - cam.principal_point(uv)) / cam.focal
    p3_s, uv_s = p3[hyp_idx], uv[hyp_idx]
    r, t, ok = _dlt_pose(p3_s, xn[hyp_idx])
    hyp = make_pose(rotmat_to_quat(r), t)
    weight = torch.ones(hyp_idx.shape, dtype=torch.bool, device=p3.device)
    hyp = _gn_refine(hyp, p3_s, uv_s, weight, cam, polish_iters)
    return hyp, ok & _all_finite(hyp)


_hyp_fn = None


def _hyp_kernel():
    """``csrc/pnp_hyp.cu``'s launch, built, loaded and typed at first use."""
    global _hyp_fn
    if _hyp_fn is None:
        from stereo_vo_tpu_torch import cuda_build

        fn = cuda_build.load("pnp_hyp").svo_pnp_hypotheses
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, p, p, i, i, f, f, f, i, p, p, p]
        fn.restype = ctypes.c_int
        _hyp_fn = fn
    return _hyp_fn


def pnp_hypotheses(p3: torch.Tensor, uv: torch.Tensor, hyp_idx: torch.Tensor,
                   cam: CameraInfo, polish_iters: int):
    """``pnp_hypotheses_ref``'s ``(hyp [H, 7], hyp_ok [H])`` for float32
    ``p3 [F, 3]``, ``uv [F, 2]`` and int64 ``hyp_idx [H, 6]`` on one
    device. CUDA tensors go through the kernel ``csrc/pnp_hyp.cu``: every
    hypothesis in one launch with no host read (each adds one to
    ``pnp_hypotheses.launches``; contiguous inputs, indices in ``[0, F)``).
    CPU tensors go through the plain version. Anything else raises."""
    dev = p3.device
    f_cap = p3.shape[0]
    for name, t, dtype, shape in (("p3", p3, torch.float32, (f_cap, 3)),
                                  ("uv", uv, torch.float32, (f_cap, 2)),
                                  ("hyp_idx", hyp_idx, torch.int64, (hyp_idx.shape[0], 6))):
        if t.dtype != dtype or tuple(t.shape) != shape or t.device != dev:
            raise ValueError(f"pnp_hypotheses: {name} must be {dtype} {shape} on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if dev.type == "cpu":
        return pnp_hypotheses_ref(p3, uv, hyp_idx, cam, polish_iters)
    if dev.type != "cuda":
        raise ValueError(f"pnp_hypotheses: unsupported device {dev}")
    if not (p3.is_contiguous() and uv.is_contiguous() and hyp_idx.is_contiguous()):
        raise ValueError("pnp_hypotheses: p3, uv and hyp_idx must be contiguous")
    n = hyp_idx.shape[0]
    hyp = torch.empty(n, 7, dtype=torch.float32, device=dev)
    ok = torch.empty(n, dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        rc = _hyp_kernel()(p3.data_ptr(), uv.data_ptr(), hyp_idx.data_ptr(), n, f_cap,
                           cam.focal, cam.cx, cam.cy, polish_iters, hyp.data_ptr(),
                           ok.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"pnp_hypotheses kernel launch failed: CUDA error {rc}")
    pnp_hypotheses.launches += 1
    return hyp, ok


pnp_hypotheses.launches = 0

_host_fn = None


def pnp_hypotheses_host(p3: torch.Tensor, uv: torch.Tensor, hyp_idx: torch.Tensor,
                        cam: CameraInfo, polish_iters: int):
    """The kernel's arithmetic on the host: ``csrc/pnp_hyp.cu`` built as
    plain C++ (``cuda_build.load_host``), one hypothesis at a time, for CPU
    tensors as ``pnp_hypotheses`` takes them. The tests hold it to the plain
    version, and the card holds the kernel to it."""
    global _host_fn
    if _host_fn is None:
        from stereo_vo_tpu_torch import cuda_build

        fn = cuda_build.load_host("pnp_hyp").svo_pnp_hypotheses_host
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, p, p, i, i, f, f, f, i, p, p]
        fn.restype = None
        _host_fn = fn
    p3, uv, hyp_idx = p3.contiguous(), uv.contiguous(), hyp_idx.contiguous()
    n = hyp_idx.shape[0]
    hyp = torch.empty(n, 7, dtype=torch.float32)
    ok = torch.empty(n, dtype=torch.bool)
    _host_fn(p3.data_ptr(), uv.data_ptr(), hyp_idx.data_ptr(), n, p3.shape[0], cam.focal,
             cam.cx, cam.cy, polish_iters, hyp.data_ptr(), ok.data_ptr())
    return hyp, ok


def pnp_ransac_core(
    p3: torch.Tensor,
    uv: torch.Tensor,
    valid: torch.Tensor,
    cam: CameraInfo,
    prev_pose: torch.Tensor,
    hyp_idx: torch.Tensor,
    cfg: FrontendConfig,
) -> PnPResult:
    """PnP-RANSAC from given minimal samples ``hyp_idx [n_hyp - 1, k]``."""
    # hypotheses 1..n_hyp-1: DLT on each minimal sample, polished on it
    hyp, hyp_ok = pnp_hypotheses(p3.contiguous(), uv.contiguous(), hyp_idx.contiguous(), cam,
                                 cfg.pnp_hyp_polish_iters)

    # hypothesis 0: warm start, trimmed GN on all points
    warm = prev_pose
    for _ in range(cfg.pnp_warm_rounds):
        e = _reproj_errors(warm, p3, uv, cam)
        w = valid & (e < 4.0 * cfg.pnp_reproj_thresh)
        warm = _gn_refine(warm, p3, uv, w, cam, cfg.pnp_warm_iters)
    warm = torch.where(_all_finite(warm), warm, prev_pose)

    hyp_poses = torch.cat([warm[None, :], hyp], dim=0)
    hyp_ok = torch.cat([torch.ones(1, dtype=torch.bool, device=p3.device), hyp_ok])
    errs = _reproj_errors(hyp_poses, p3, uv, cam)                  # [H, F]
    inl = (errs < cfg.pnp_reproj_thresh) & valid[None, :]
    counts = torch.where(hyp_ok, torch.sum(inl, dim=1), -1)
    best = torch.argmax(counts).reshape(1)                         # first max
    pose = torch.index_select(hyp_poses, 0, best)[0]
    inl_set = torch.index_select(inl, 0, best)[0]

    # LO-RANSAC: refine on the inlier set, recount, keep if no inlier is lost
    for _ in range(cfg.pnp_lo_rounds):
        cand = _gn_refine(pose, p3, uv, inl_set, cam, cfg.pnp_refine_iters)
        cand = torch.where(_all_finite(cand), cand, pose)
        inl_c = (_reproj_errors(cand, p3, uv, cam) < cfg.pnp_reproj_thresh) & valid
        keep = torch.sum(inl_c) >= torch.sum(inl_set)
        pose = torch.where(keep, cand, pose)
        inl_set = torch.where(keep, inl_c, inl_set)
    out_n = torch.sum(inl_set.to(torch.int32))
    ok = out_n >= max(cfg.pnp_sample_size, 4)
    return PnPResult(pose=pose, inliers=inl_set, num_inliers=out_n, ok=ok)


def sample_hypotheses(valid: torch.Tensor, n_draws: int, k: int, seed) -> torch.Tensor:
    """``[n_draws, k]`` int64 minimal-sample indices on ``valid``'s device:
    exactly the reference's draw, ``jax.random.choice(key_i, F, (k,),
    replace=False, p=valid / n_valid)`` with ``key_i`` the rows of
    ``split(PRNGKey(seed), n_draws)``, by the Gumbel top-k trick.

    Each row is the ``k`` largest of ``gumbel(key_i) + log(p)``, ties to the
    lower index (a stable descending sort, as ``lax.top_k``). Invalid slots
    score ``-inf``, so with fewer than ``k`` valid slots the lowest-index
    invalid ones fill the row, and with none it is ``0..k-1``.

    Everything runs on ``valid``'s device from ``seed``, a Python int or a
    0-d integer tensor on that device: no value is read back to the host and
    nothing is copied to the device. The first
    call on a device builds the tables of ``prng.gumbel_table`` and
    ``prng.log_inverse_counts`` there."""
    dev = valid.device
    f_cap = valid.shape[0]
    keys = prng.split(prng.prng_key(seed, device=dev), n_draws)
    n_valid = torch.sum(valid.to(torch.int64)).reshape(1)
    log_p = torch.index_select(prng.log_inverse_counts(f_cap, dev), 0, n_valid)
    score = prng.gumbel(keys, f_cap) + torch.where(valid, log_p, float("-inf"))
    return torch.sort(score, dim=1, descending=True, stable=True).indices[:, :k]


def pnp_ransac(
    p3: torch.Tensor,
    uv: torch.Tensor,
    valid: torch.Tensor,
    cam: CameraInfo,
    prev_pose: torch.Tensor,
    seed,
    cfg: FrontendConfig,
    hyp_idx: Optional[torch.Tensor] = None,
) -> PnPResult:
    """Estimate T_cw from fixed-capacity correspondences ``p3 [F, 3]``,
    ``uv [F, 2]``, ``valid [F]``; ``seed`` (the frame index, a Python int or
    a 0-d integer tensor on the device, as the reference passes
    ``state.frame_idx``) seeds the sampling unless ``hyp_idx`` is given. No
    value is read back to the host."""
    if hyp_idx is None:
        hyp_idx = sample_hypotheses(valid, cfg.pnp_iterations - 1, cfg.pnp_sample_size, seed)
    return pnp_ransac_core(p3, uv, valid, cam, prev_pose, hyp_idx, cfg)
