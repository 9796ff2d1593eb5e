"""Sparse block-matching stereo at feature pixels (counterpart of
``stereo_vo_tpu/ops/stereo_bm.py::stereo_bm_at``).

cv::StereoBM(48, 21) semantics evaluated only where disparity is consumed:
XSobel prefilter clipped to ``[0, 2*cap]``, 21x21 SAD over the disparity
candidates, texture threshold, uniqueness ratio, sub-pixel parabola, and -1
for invalid pixels. Bit-exact with the reference: prefiltered values are
integers <= 2*cap, so every SAD is an exact f32 integer, and ``argmin`` takes
the first minimum over ascending disparity in both.

Each feature extracts a left window region and a right search-band region
(``ops.regions.extract_regions``, the CUDA kernel on the card); the 48 SADs
are one batched ``unfold`` expression. The dense ``stereo_bm_disparity`` is
not ported yet.
"""

from __future__ import annotations

import torch

from stereo_vo_tpu_torch.ops.filters import sobel_x
from stereo_vo_tpu_torch.ops.regions import extract_regions, pad_edge


def _xsobel_prefilter(img: torch.Tensor, cap: int) -> torch.Tensor:
    s = sobel_x(img.to(torch.float32), mode="reflect")
    return torch.clamp(s + cap, 0.0, 2.0 * cap)


def _take_window(reg: torch.Tensor, row0: torch.Tensor, col0: torch.Tensor,
                 wy: int, wx: int) -> torch.Tensor:
    """Integer-offset ``[N, wy, wx]`` window of each ``[N, RY, RX]`` region;
    samples outside the region read zero."""
    n, size_y, size_x = reg.shape
    iy = row0[:, None] + torch.arange(wy, device=reg.device)
    ix = col0[:, None] + torch.arange(wx, device=reg.device)
    ok = (((iy >= 0) & (iy < size_y))[:, :, None]
          & ((ix >= 0) & (ix < size_x))[:, None, :])
    b = torch.arange(n, device=reg.device)[:, None, None]
    vals = reg[b, iy.clamp(0, size_y - 1)[:, :, None], ix.clamp(0, size_x - 1)[:, None, :]]
    return torch.where(ok, vals, 0.0)


def disparity_at(disparity: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Disparity at truncated-int feature coordinates (``disparity.at(y, x)``)."""
    h, w = disparity.shape
    xi = torch.clamp(xy[..., 0].to(torch.int64), 0, w - 1)
    yi = torch.clamp(xy[..., 1].to(torch.int64), 0, h - 1)
    return disparity[yi, xi]


def stereo_bm_at(
    left: torch.Tensor,
    right: torch.Tensor,
    xy: torch.Tensor,
    valid: torch.Tensor,
    num_disparities: int = 48,
    block_size: int = 21,
    prefilter_cap: int = 31,
    texture_threshold: int = 10,
    uniqueness_ratio: int = 15,
    compact_slots: int = 0,
) -> torch.Tensor:
    """StereoBM disparity at feature pixels ``xy [N, 2]``; -1 where invalid.

    ``compact_slots``: when > 0 and at most that many inputs are valid, match
    exactly ``compact_slots`` slots (valid first, stable order) and scatter
    the results back; otherwise match at full width. Per-feature results do
    not depend on batch position, so both give the same answer.
    """
    kw = dict(
        num_disparities=num_disparities, block_size=block_size,
        prefilter_cap=prefilter_cap, texture_threshold=texture_threshold,
        uniqueness_ratio=uniqueness_ratio,
    )
    n_in = xy.shape[0]
    k = compact_slots
    if 0 < k < n_in and int(valid.sum()) <= k:
        idx = torch.sort((~valid).to(torch.uint8), stable=True).indices[:k]
        disp_c = _stereo_bm_at_full(left, right, xy[idx], valid[idx], **kw)
        out = torch.full((n_in,), -1.0, dtype=torch.float32, device=xy.device)
        out[idx] = disp_c
        return out
    return _stereo_bm_at_full(left, right, xy, valid, **kw)


def _stereo_bm_at_full(
    left: torch.Tensor,
    right: torch.Tensor,
    xy: torch.Tensor,
    valid: torch.Tensor,
    num_disparities: int = 48,
    block_size: int = 21,
    prefilter_cap: int = 31,
    texture_threshold: int = 10,
    uniqueness_ratio: int = 15,
) -> torch.Tensor:
    """Per-feature BM over every input slot (see ``stereo_bm_at``)."""
    h, w = left.shape
    radius = block_size // 2
    d_max = num_disparities
    cap = float(prefilter_cap)
    win = block_size
    band = num_disparities + block_size - 1

    lpre = _xsobel_prefilter(left, prefilter_cap)
    rpre = _xsobel_prefilter(right, prefilter_cap)

    # truncated-int lookup coordinates (disparity_at semantics)
    xi = torch.clamp(xy[:, 0].to(torch.int64), 0, w - 1)
    yi = torch.clamp(xy[:, 1].to(torch.int64), 0, h - 1)

    # left window region and right search-band region per feature, origins
    # aligned down to 8 exactly as the reference places them
    m = d_max + radius + 8
    ry = (win + 7 + 7) // 8 * 8
    rx_l = ry
    rx_r = (band + 7 + 7) // 8 * 8
    lp = pad_edge(lpre[None], m)
    rp = pad_edge(rpre[None], m)
    hp, wp = lp.shape[-2:]

    def floor8(v):
        return torch.div(v, 8, rounding_mode="floor") * 8

    oy = torch.clamp(floor8(yi - radius + m), 0, hp - ry)
    ox_l = torch.clamp(floor8(xi - radius + m), 0, wp - rx_l)
    ox_r = torch.clamp(floor8(xi - (d_max - 1) - radius + m), 0, wp - rx_r)
    org_l = torch.stack([ox_l, oy], dim=1).to(torch.int32).contiguous()
    org_r = torch.stack([ox_r, oy], dim=1).to(torch.int32).contiguous()
    lreg = extract_regions(lp, org_l, ry, rx_l)[:, 0]
    rreg = extract_regions(rp, org_r, ry, rx_r)[:, 0]

    py = yi + m - oy
    px_l = xi + m - ox_l
    px_r = xi + m - ox_r
    lwin = _take_window(lreg, py - radius, px_l - radius, win, win)            # [N, win, win]
    rband = _take_window(rreg, py - radius, px_r - (d_max - 1) - radius, win, band)

    # SAD per disparity: the right window for d starts at band offset
    # (d_max - 1) - d; unfold gives offsets 0..d_max-1, flipped to ascending d
    shifted = rband.unfold(2, win, 1)                   # [N, win, d_max, win]
    sads = torch.sum(torch.abs(lwin[:, :, None, :] - shifted), dim=(1, 3))
    sads = torch.flip(sads, dims=(1,)).T                # [D, N]

    best_d = torch.argmin(sads, dim=0)                  # first minimum
    best_c = torch.amin(sads, dim=0)
    ds = torch.arange(num_disparities, device=xy.device)[:, None]
    near = torch.abs(ds - best_d[None]) <= 1
    second = torch.amin(torch.where(near, float("inf"), sads), dim=0)
    unique_ok = second * 100.0 >= best_c * (100.0 + uniqueness_ratio)
    tex = torch.sum(torch.abs(lwin - cap), dim=(1, 2))
    tex_ok = tex >= texture_threshold
    inside = (
        (yi >= radius)
        & (yi < h - radius)
        & (xi >= num_disparities + radius - 1)
        & (xi < w - radius)
    )
    d0 = torch.clamp(best_d, 1, num_disparities - 2)
    c_m = torch.gather(sads, 0, (d0 - 1)[None])[0]
    c_0 = torch.gather(sads, 0, d0[None])[0]
    c_p = torch.gather(sads, 0, (d0 + 1)[None])[0]
    denom = torch.clamp(c_m + c_p - 2.0 * c_0, min=1e-9)
    delta = torch.clamp((c_m - c_p) / (2.0 * denom), -0.5, 0.5)
    disp = torch.where(best_d == d0, best_d + delta, best_d.to(torch.float32))
    ok = inside & unique_ok & tex_ok & valid
    return torch.where(ok, disp, -1.0).to(torch.float32)
