"""Batched pyramidal Lucas-Kanade, with fused forward-backward verification
(``lk_track_fwdbwd``) or forward only (``lk_track_pyramid``); counterpart of
``stereo_vo_tpu/ops/lk.py``.

Replaces ``cv::calcOpticalFlowPyrLK(..., Size(21,21), 3, {30 iters, eps 0.01})``
with a fixed-capacity batched op: all N features advance together through the
pyramid, coarse to fine. Per level, each feature extracts one region of the
previous and one of the next image around its template point and its guess
(``ops.regions.extract_regions``, the CUDA kernel on the card), and every
Gauss-Newton iteration samples its 21x21 window from those regions by direct
bilinear indexing. The backward (verification) pass reuses the same regions
with the roles swapped.

Semantics kept from the reference, because they change outcomes:
- region origins ``(floor(c) - half - slack + m) // 8 * 8`` clipped to
  ``[0, dim - size]``: the region bounds decide ``in_region`` failures;
- the min-eigenvalue and determinant gates, the ``eps`` stop, oscillation
  halving, the exact ``max_iters`` cap, and the level-0-only kill;
- in-patch Scharr gradients of the sampled template (exact by linearity);
- per-feature region centering (the prev-region mean subtracted from both
  regions), which keeps the f32 sampling arithmetic the reference's.

The GN loop runs at most ``max_iters`` masked iterations and checks every
``CONVERGED_CHECK_EVERY`` iterations whether all features have converged, one
host sync per check. A converged feature is frozen by the ``upd`` mask, so the
early exit changes no result; it only skips no-op iterations.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from stereo_vo_tpu_torch.ops.filters import scharr_x, scharr_y
from stereo_vo_tpu_torch.ops.regions import extract_regions, pad_edge

# per-level refinement slack in pixels (region = window + 2*slack); the top
# level absorbs the full scaled motion
LK_SLACK = 10
LK_SLACK_TOP = 26

CONVERGED_CHECK_EVERY = 3


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

    Returns ``(guess', solvable, in_region(guess'))``."""
    win = 2 * half + 1
    ry, rx = it_reg.shape[-2], it_reg.shape[-1]
    win_area = float(win * win)
    t_patch, gx_p, gy_p = _sample_template(tpl_reg, tpl_pos, win)

    g11 = torch.sum(gx_p * gx_p, dim=(1, 2))
    g12 = torch.sum(gx_p * gy_p, dim=(1, 2))
    g22 = torch.sum(gy_p * gy_p, dim=(1, 2))
    tr = g11 + g22
    det = g11 * g22 - g12 * g12
    min_eig = (tr - torch.sqrt(torch.clamp(tr * tr - 4 * det, min=0.0))) * 0.5
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
        guess = new_guess
    return guess, solvable, _in_region(guess, half, m, org, ry, rx, win)


def _origins(centers, half, slack, m, hp, wp, ry, rx):
    """Region origins (padded coords), aligned down to 8 and clipped."""
    c = torch.nan_to_num(torch.floor(centers)).clamp(-2.0 ** 30, 2.0 ** 30).to(torch.int64)
    ox = c[:, 0] - half - slack + m
    ox = torch.clamp(torch.div(ox, 8, rounding_mode="floor") * 8, 0, wp - rx)
    oy = c[:, 1] - half - slack + m
    oy = torch.clamp(torch.div(oy, 8, rounding_mode="floor") * 8, 0, hp - ry)
    return torch.stack([ox, oy], dim=1).to(torch.int32).contiguous()


def _center_regions(prev_reg, next_reg):
    """Subtract each feature's prev-region mean from both regions."""
    c = torch.mean(prev_reg, dim=(-2, -1), keepdim=True)
    return prev_reg - c, next_reg - c


def _image_inside(g, h, w):
    return (g[:, 0] >= 0) & (g[:, 0] <= w - 1) & (g[:, 1] >= 0) & (g[:, 1] <= h - 1)


def _lk_level(prev_img, next_img, pts_prev, guess, active, half, slack, max_iters, eps,
              min_eig_threshold, is_level0):
    """One forward level pass for all features: two region extractions, one
    template sample + GN pass. Returns ``(guess', ok, regions)``, ``regions``
    being ``(prev_reg, next_reg, prev_org, next_org, m)`` for a backward
    pass; only level 0 kills features, higher levels pass ``active`` through."""
    h, w = prev_img.shape
    win = 2 * half + 1
    rx = ry = ((win + 2 + 2 * slack + 9) + 7) // 8 * 8
    m = half + slack + 2
    prev_p = pad_edge(prev_img[None], m)
    next_p = pad_edge(next_img[None], m)
    hp, wp = prev_p.shape[-2:]
    prev_org = _origins(pts_prev, half, slack, m, hp, wp, ry, rx)
    next_org = _origins(guess, half, slack, m, hp, wp, ry, rx)
    prev_reg = extract_regions(prev_p, prev_org, ry, rx)[:, 0]
    next_reg = extract_regions(next_p, next_org, ry, rx)[:, 0]
    prev_reg, next_reg = _center_regions(prev_reg, next_reg)
    tpl_pos = pts_prev - half + m - prev_org.to(pts_prev.dtype)
    guess, solvable, inside_reg = _gn_pass(
        prev_reg, next_reg, tpl_pos, guess, active, half,
        max_iters, eps, min_eig_threshold, next_org, m,
    )
    ok = solvable & _image_inside(guess, h, w) & inside_reg if is_level0 else active
    return guess, ok, (prev_reg, next_reg, prev_org, next_org, m)


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
    ``LK_SLACK_TOP``; each level makes two ``extract_regions`` calls."""
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

    # ---------- forward pass, caching regions per level
    guess = (pts if init_flow is None else pts + init_flow) / float(2 ** (n_levels - 1))
    cache = []
    for lvl in range(n_levels - 1, -1, -1):
        guess, fwd_ok, regions = _lk_level(
            prev_pyr[lvl], next_pyr[lvl], pts / float(2 ** lvl), guess, valid, half,
            slack_top if lvl == n_levels - 1 else slack,
            max_iters, eps, min_eig_threshold, is_level0=(lvl == 0),
        )
        if lvl < bwd_levels:
            cache.append((lvl, *regions, prev_pyr[lvl].shape))
        if lvl > 0:
            guess = guess * 2.0
    tracked = guess
    fwd_ok = fwd_ok & valid

    # ---------- backward pass over the cached regions (roles swapped)
    bguess = (
        tracked if (bwd_levels >= n_levels and not bwd_from_original) else pts
    ) / float(2 ** (bwd_levels - 1))
    bok = fwd_ok
    bwd_ok = None
    for (lvl, prev_reg, next_reg, prev_org, next_org, m, (h, w)) in cache:
        tracked_l = tracked / float(2 ** lvl)
        tpl_pos = tracked_l - half + m - next_org.to(pts.dtype)
        bguess, bsolv, b_inside_reg = _gn_pass(
            next_reg, prev_reg, tpl_pos, bguess, bok, half,
            max_iters, eps, min_eig_threshold, prev_org, m,
        )
        if lvl == 0:
            bwd_ok = bsolv & _image_inside(bguess, h, w) & b_inside_reg & fwd_ok
        if lvl > 0:
            bguess = bguess * 2.0

    return tracked, fwd_ok, bguess, bwd_ok
