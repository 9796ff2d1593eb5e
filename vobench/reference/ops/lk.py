"""Batched pyramidal Lucas-Kanade, with fused forward-backward verification
(``lk_track_fwdbwd``) or forward only (``lk_track_pyramid``); counterpart of
``stereo_vo_tpu/ops/lk.py``.

Replaces ``cv::calcOpticalFlowPyrLK(..., Size(21,21), 3, {30 iters, eps 0.01})``
with a fixed-capacity batched op: all N features advance together through the
pyramid, coarse to fine. Every level pass, forward or backward, is one call of
``lk_level_pass``: per feature, one region of the template image around its
template point and one of the other image around its guess, both centered by
one constant, the template sample, and the Gauss-Newton loop that samples its
21x21 window from the region by direct bilinear indexing. On the card that is
one launch of the hand-written kernel ``csrc/lk_level.cu``, which keeps both
regions in shared memory; on the CPU, the plain version ``lk_level_pass_ref``.
The backward (verification) pass re-stages the same regions with the roles
swapped and the forward pass's centering constant.

Semantics kept from the reference, because they change outcomes:
- region origins ``(floor(c) - half - slack + m) // 8 * 8`` clipped to
  ``[0, dim - size]``: the region bounds decide ``in_region`` failures;
- the min-eigenvalue and determinant gates, the ``eps`` stop, oscillation
  halving, the exact ``max_iters`` cap, and the level-0-only kill;
- in-patch Scharr gradients of the sampled template (exact by linearity);
- per-feature region centering (the forward prev-region mean subtracted from
  both regions), which keeps the f32 sampling arithmetic the reference's.

The plain version's GN loop runs at most ``max_iters`` masked iterations and
checks every ``CONVERGED_CHECK_EVERY`` iterations whether all features have
converged, one host sync per check; the kernel stops each feature when it
converges. A converged feature is frozen by the ``upd`` mask, so neither early
exit changes a result; they only skip no-op iterations.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from vobench.reference.core.f32 import sqrt_f32
from vobench.reference.ops.filters import scharr_x, scharr_y
from vobench.reference.ops.regions import extract_regions_ref, pad_edge

# per-level refinement slack in pixels (region = window + 2*slack); the top
# level absorbs the full scaled motion
LK_SLACK = 10
LK_SLACK_TOP = 26

CONVERGED_CHECK_EVERY = 3

# largest window the kernel takes: 128 threads own at most 8 samples each
MAX_WINDOW_AREA = 1024


def _rows_or_zero(src: torch.Tensor, idx: torch.Tensor, dim: int) -> torch.Tensor:
    """``src`` [N, A, B] indexed along ``dim`` (1 or 2) by per-feature indices
    ``idx`` [N, K]; indices outside the axis read zero."""
    size = src.shape[dim]
    ok = (idx >= 0) & (idx < size)
    safe = idx.clamp(0, size - 1)
    if dim == 1:
        g = torch.gather(src, 1, safe[:, :, None].expand(-1, -1, src.shape[2]))
        return torch.where(ok[:, :, None], g, 0.0)
    g = torch.gather(src, 2, safe[:, None, :].expand(-1, src.shape[1], -1))
    return torch.where(ok[:, None, :], g, 0.0)


def sample_window(regions: torch.Tensor, pos: torch.Tensor, win: int) -> torch.Tensor:
    """Bilinear ``[N, win, win]`` windows from 1-channel regions ``[N, RY, RX]``
    at continuous region coordinates ``pos [N, 2]`` (x, y of the top-left).

    Rows first, then columns, each as ``(1 - f) * v0 + f * v1``; samples that
    fall outside the region read zero (the reference's selector matrices give
    them zero weight)."""
    x0 = torch.floor(pos[:, 0])
    y0 = torch.floor(pos[:, 1])
    fx = (pos[:, 0] - x0)[:, None, None]
    fy = (pos[:, 1] - y0)[:, None, None]
    ar = torch.arange(win, device=regions.device)
    iy = y0.to(torch.int64)[:, None] + ar
    ix = x0.to(torch.int64)[:, None] + ar
    tmp = (1.0 - fy) * _rows_or_zero(regions, iy, 1) + fy * _rows_or_zero(regions, iy + 1, 1)
    return (1.0 - fx) * _rows_or_zero(tmp, ix, 2) + fx * _rows_or_zero(tmp, ix + 1, 2)


def _sample_template(regions: torch.Tensor, pos: torch.Tensor, win: int):
    """Template window and its Scharr gradients ``(t, gx, gy)`` [N, win, win]:
    sample a (win+2)^2 patch and differentiate inside it."""
    patch = sample_window(regions, pos - 1.0, win + 2)
    gx = scharr_x(patch)[..., 1:-1, 1:-1]
    gy = scharr_y(patch)[..., 1:-1, 1:-1]
    return patch[..., 1:-1, 1:-1], gx, gy


def _in_region(g, half, m, org_f, ry, rx, win):
    pos = g - half + m - org_f
    return (
        (pos[:, 0] >= 0) & (pos[:, 0] <= rx - win - 1)
        & (pos[:, 1] >= 0) & (pos[:, 1] <= ry - win - 1)
    )


def _gn_pass(tpl_reg, it_reg, tpl_pos, guess, active, half, max_iters, eps,
             min_eig_threshold, it_org, m):
    """Template sample + masked GN iteration of one level pass.

    Returns ``(guess', solvable, in_region(guess'), iterations)``, the last
    being the int32 count of updates each feature made."""
    win = 2 * half + 1
    ry, rx = it_reg.shape[-2], it_reg.shape[-1]
    win_area = float(win * win)
    t_patch, gx_p, gy_p = _sample_template(tpl_reg, tpl_pos, win)

    g11 = torch.sum(gx_p * gx_p, dim=(1, 2))
    g12 = torch.sum(gx_p * gy_p, dim=(1, 2))
    g22 = torch.sum(gy_p * gy_p, dim=(1, 2))
    tr = g11 + g22
    det = g11 * g22 - g12 * g12
    min_eig = (tr - sqrt_f32(torch.clamp(tr * tr - 4 * det, min=0.0))) * 0.5
    eig_ok = (min_eig / win_area) >= min_eig_threshold
    det_ok = det > 1e-12
    solvable = eig_ok & det_ok & active

    safe_det = torch.where(det_ok, det, 1.0)
    inv11 = torch.where(det_ok, g22 / safe_det, 0.0)
    inv12 = torch.where(det_ok, -g12 / safe_det, 0.0)
    inv22 = torch.where(det_ok, g11 / safe_det, 0.0)

    org = it_org.to(guess.dtype)
    lim = torch.tensor([rx - win - 1, ry - win - 1], dtype=guess.dtype, device=guess.device)
    converged = ~solvable
    prev_step = torch.zeros_like(guess)
    iterations = torch.zeros(guess.shape[0], dtype=torch.int32, device=guess.device)
    for it in range(max_iters):
        if it and it % CONVERGED_CHECK_EVERY == 0 and bool(converged.all()):
            break
        pos = torch.clamp(guess - half + m - org, min=0.0)
        pos = torch.minimum(pos, lim)
        j_patch = sample_window(it_reg, pos, win)
        di = j_patch - t_patch
        bx = torch.sum(di * gx_p, dim=(1, 2))
        by = torch.sum(di * gy_p, dim=(1, 2))
        step = torch.stack([-(inv11 * bx + inv12 * by), -(inv12 * bx + inv22 * by)], dim=-1)
        # OpenCV's oscillation break
        if it > 0:
            osc = torch.sum(step * prev_step, dim=-1) < -0.01
            step = torch.where(osc[:, None], 0.5 * step, step)
        else:
            osc = torch.zeros_like(converged)
        upd = solvable & ~converged
        new_guess = torch.where(upd[:, None], guess + step, guess)
        small = torch.sum(step * step, dim=-1) < eps * eps
        converged = (converged | small | osc
                     | ~_in_region(new_guess, half, m, org, ry, rx, win) | ~solvable)
        prev_step = torch.where(upd[:, None], step, prev_step)
        iterations += upd.to(torch.int32)
        guess = new_guess
    return guess, solvable, _in_region(guess, half, m, org, ry, rx, win), iterations


def level_geometry(half, slack):
    """``(region, m)`` of a level pass: the square region's side, (window +
    gradient ring) + slack each side + bilinear margin + up to 7 px of
    alignment residual rounded up to 8, and the image pad."""
    return ((2 * half + 1 + 2 + 2 * slack + 9) + 7) // 8 * 8, half + slack + 2


def _origins(centers, half, slack, m, hp, wp, ry, rx):
    """Region origins (padded coords), aligned down to 8 and clipped."""
    c = torch.nan_to_num(torch.floor(centers)).clamp(-2.0 ** 30, 2.0 ** 30).to(torch.int64)
    ox = c[:, 0] - half - slack + m
    ox = torch.clamp(torch.div(ox, 8, rounding_mode="floor") * 8, 0, wp - rx)
    oy = c[:, 1] - half - slack + m
    oy = torch.clamp(torch.div(oy, 8, rounding_mode="floor") * 8, 0, hp - ry)
    return torch.stack([ox, oy], dim=1).to(torch.int32).contiguous()


def _check_pass(tpl_img, it_img, tpl_org, it_org, tpl_pos, guess, active, center,
                half, m, region, max_iters):
    """Validate a level pass's arguments; returns their common device."""
    if tpl_img.dim() != 2 or tpl_img.dtype != torch.float32 or it_img.shape != tpl_img.shape \
            or it_img.dtype != torch.float32:
        raise ValueError(f"images must be two [H, W] float32 tensors of one shape, got "
                         f"{tuple(tpl_img.shape)} {tpl_img.dtype} and "
                         f"{tuple(it_img.shape)} {it_img.dtype}")
    n = guess.shape[0] if guess.dim() == 2 else -1
    for name, t, shape, dtype in (
        ("tpl_org", tpl_org, (n, 2), torch.int32), ("it_org", it_org, (n, 2), torch.int32),
        ("tpl_pos", tpl_pos, (n, 2), torch.float32), ("guess", guess, (n, 2), torch.float32),
        ("active", active, (n,), torch.bool),
    ) + ((("center", center, (n,), torch.float32),) if center is not None else ()):
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name} must be {list(shape)} {dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
    tensors = [tpl_img, it_img, tpl_org, it_org, tpl_pos, guess, active]
    if center is not None:
        tensors.append(center)
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"level-pass tensors lie on several devices: "
                         f"{sorted({str(t.device) for t in tensors})}")
    h, w = tpl_img.shape
    win = 2 * half + 1
    if not (half >= 0 and win * win <= MAX_WINDOW_AREA and m >= 0 and max_iters >= 0):
        raise ValueError(f"unsupported half window {half}, margin {m} or max_iters {max_iters}")
    if not 0 < region <= min(h, w) + 2 * m:
        raise ValueError(f"region {region} does not fit a {h}x{w} image padded by {m}")
    return tpl_img.device


def lk_level_pass_ref(tpl_img, it_img, tpl_org, it_org, tpl_pos, guess, active, center,
                      half, m, region, max_iters, eps, min_eig_threshold):
    """Plain PyTorch version of one level pass: edge-pad both level images
    by ``m``, copy each feature's ``region x region`` template region (of
    ``tpl_img`` at ``tpl_org``) and iteration region (of ``it_img`` at
    ``it_org``), subtract the centering constant from both, and run the
    template sample + GN loop (``_gn_pass``).

    ``center`` [N] is the per-feature centering constant; ``None`` (the
    forward role) takes the template region's mean. Returns ``(guess',
    solvable, in_region(guess'), center, iterations)``."""
    _check_pass(tpl_img, it_img, tpl_org, it_org, tpl_pos, guess, active, center,
                half, m, region, max_iters)
    tpl_reg = extract_regions_ref(pad_edge(tpl_img[None], m), tpl_org, region, region)[:, 0]
    it_reg = extract_regions_ref(pad_edge(it_img[None], m), it_org, region, region)[:, 0]
    if center is None:
        center = torch.mean(tpl_reg, dim=(-2, -1))
    c = center[:, None, None]
    guess, solvable, inside_reg, iterations = _gn_pass(
        tpl_reg - c, it_reg - c, tpl_pos, guess, active, half,
        max_iters, eps, min_eig_threshold, it_org, m,
    )
    return guess, solvable, inside_reg, center, iterations




def _image_inside(g, h, w):
    return (g[:, 0] >= 0) & (g[:, 0] <= w - 1) & (g[:, 1] >= 0) & (g[:, 1] <= h - 1)


def _lk_level(prev_img, next_img, pts_prev, guess, active, half, slack, max_iters, eps,
              min_eig_threshold, is_level0):
    """One forward level pass for all features (one ``lk_level_pass``).
    Returns ``(guess', ok, pass_args)``, ``pass_args`` being ``(prev_org,
    next_org, center, m, region)`` for a backward pass over the same
    regions; only level 0 kills features, higher levels pass ``active``
    through."""
    h, w = prev_img.shape
    region, m = level_geometry(half, slack)
    hp, wp = h + 2 * m, w + 2 * m
    prev_org = _origins(pts_prev, half, slack, m, hp, wp, region, region)
    next_org = _origins(guess, half, slack, m, hp, wp, region, region)
    tpl_pos = pts_prev - half + m - prev_org.to(pts_prev.dtype)
    guess, solvable, inside_reg, center, _ = lk_level_pass(
        prev_img, next_img, prev_org, next_org, tpl_pos, guess, active, None,
        half, m, region, max_iters, eps, min_eig_threshold,
    )
    ok = solvable & _image_inside(guess, h, w) & inside_reg if is_level0 else active
    return guess, ok, (prev_org, next_org, center, m, region)


def lk_track_pyramid(
    prev_pyr: List[torch.Tensor],
    next_pyr: List[torch.Tensor],
    pts: torch.Tensor,
    valid: torch.Tensor,
    window: int = 21,
    max_iters: int = 30,
    eps: float = 0.01,
    min_eig_threshold: float = 1e-2,
    slack: int = LK_SLACK,
):
    """Forward-only pyramidal LK: track ``pts [N, 2]`` from ``prev_pyr`` to
    ``next_pyr`` (lists of level 0..L images). Returns ``(tracked [N, 2],
    status [N] bool)``; invalid input slots stay invalid. The top level uses
    ``LK_SLACK_TOP``; each level is one ``lk_level_pass``."""
    half = window // 2
    n_levels = len(prev_pyr)
    guess = pts / float(2 ** (n_levels - 1))
    ok = valid
    for lvl in range(n_levels - 1, -1, -1):
        guess, ok, _ = _lk_level(
            prev_pyr[lvl], next_pyr[lvl], pts / float(2 ** lvl), guess, ok, half,
            LK_SLACK_TOP if lvl == n_levels - 1 else slack,
            max_iters, eps, min_eig_threshold, is_level0=(lvl == 0),
        )
        if lvl > 0:
            guess = guess * 2.0
    return guess, ok & valid


def lk_track_fwdbwd(
    prev_pyr: List[torch.Tensor],
    next_pyr: List[torch.Tensor],
    pts: torch.Tensor,
    valid: torch.Tensor,
    window: int = 21,
    max_iters: int = 30,
    eps: float = 0.01,
    min_eig_threshold: float = 1e-2,
    slack: int = LK_SLACK,
    slack_top: int = LK_SLACK_TOP,
    bwd_levels: int = 0,
    init_flow: Optional[torch.Tensor] = None,
    bwd_from_original: bool = False,
):
    """Forward track + backward verification in one fused pass.

    Returns ``(tracked [N, 2], fwd_ok [N], back [N, 2], bwd_ok [N])``.
    ``bwd_levels`` limits the backward pass to the finest levels (0 = all,
    initialized at the forward endpoint; a truncated pass initializes at the
    original point). ``init_flow`` warm-starts the forward search at
    ``pts + init_flow``; ``bwd_from_original`` forces the truncated backward
    initialization on a full-depth pass (short hinted pyramids).
    """
    half = window // 2
    n_levels = len(prev_pyr)
    if bwd_levels <= 0:
        bwd_levels = n_levels

    # ---------- forward pass, caching what re-stages each level's regions
    guess = (pts if init_flow is None else pts + init_flow) / float(2 ** (n_levels - 1))
    cache = []
    for lvl in range(n_levels - 1, -1, -1):
        guess, fwd_ok, pass_args = _lk_level(
            prev_pyr[lvl], next_pyr[lvl], pts / float(2 ** lvl), guess, valid, half,
            slack_top if lvl == n_levels - 1 else slack,
            max_iters, eps, min_eig_threshold, is_level0=(lvl == 0),
        )
        if lvl < bwd_levels:
            cache.append((lvl, *pass_args))
        if lvl > 0:
            guess = guess * 2.0
    tracked = guess
    fwd_ok = fwd_ok & valid

    # ---------- backward pass over the same regions (roles swapped)
    bguess = (
        tracked if (bwd_levels >= n_levels and not bwd_from_original) else pts
    ) / float(2 ** (bwd_levels - 1))
    bok = fwd_ok
    bwd_ok = None
    for (lvl, prev_org, next_org, center, m, region) in cache:
        tracked_l = tracked / float(2 ** lvl)
        tpl_pos = tracked_l - half + m - next_org.to(pts.dtype)
        bguess, bsolv, b_inside_reg, _, _ = lk_level_pass(
            next_pyr[lvl], prev_pyr[lvl], next_org, prev_org, tpl_pos, bguess, bok, center,
            half, m, region, max_iters, eps, min_eig_threshold,
        )
        if lvl == 0:
            h, w = prev_pyr[lvl].shape
            bwd_ok = bsolv & _image_inside(bguess, h, w) & b_inside_reg & fwd_ok
        if lvl > 0:
            bguess = bguess * 2.0

    return tracked, fwd_ok, bguess, bwd_ok


lk_level_pass = lk_level_pass_ref
