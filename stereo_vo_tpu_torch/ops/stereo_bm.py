"""Block-matching stereo, dense and at feature pixels (counterpart of
``stereo_vo_tpu/ops/stereo_bm.py``).

cv::StereoBM(48, 21) semantics: XSobel prefilter clipped to ``[0, 2*cap]``,
21x21 SAD over the disparity candidates, texture threshold, uniqueness ratio,
sub-pixel parabola, and -1 for invalid pixels. Bit-exact with the reference:
prefiltered values are integers <= 2*cap, so every SAD is an exact f32
integer, and ``argmin`` takes the first minimum over ascending disparity in
both.

``stereo_bm_disparity`` builds the whole ``[D, H, W]`` cost volume (90 MB in
f32 at 376x1241) with windowed sliding sums, so an inside pixel's cost never
sums the 1e6 fill of the columns left of its shift.

``stereo_bm_at`` matches only at features. On a CUDA tensor it is one launch
of the hand-written kernel ``csrc/stereo_bm_at.cu`` per call: a block per
slot stages the raw pixels the slot reads, prefilters them, matches all D
disparities and runs the validity tests in shared memory, and an invalid
slot exits at once, so the live-set compaction has nothing to do there. On a
CPU tensor it runs the plain version ``stereo_bm_at_ref``: the prefilter over
both whole images, a left window region and a right search-band region per
feature copied by ``ops.regions.extract_regions_ref``, the D SADs as one
batched ``unfold`` expression, and the compaction.
"""

from __future__ import annotations

import ctypes

import torch

from stereo_vo_tpu_torch.ops.filters import box_filter, box_sum_tree, sobel_x
from stereo_vo_tpu_torch.ops.regions import extract_regions_ref, pad_edge


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


def _subpixel_valid(costs, best_d, best_c, num_disparities, uniqueness_ratio):
    """Uniqueness test and sub-pixel parabola from the ``[D, ...]`` costs:
    ``(disp, unique_ok)``. The parabola is taken at ``clip(best, 1, D-2)``
    and used only where that equals ``best``."""
    ds = torch.arange(num_disparities, device=costs.device).reshape(
        (-1,) + (1,) * best_d.dim())
    near = torch.abs(ds - best_d[None]) <= 1
    second = torch.amin(torch.where(near, float("inf"), costs), dim=0)
    unique_ok = second * 100.0 >= best_c * (100.0 + uniqueness_ratio)
    d0 = torch.clamp(best_d, 1, num_disparities - 2)
    c_m = torch.gather(costs, 0, (d0 - 1)[None])[0]
    c_0 = torch.gather(costs, 0, d0[None])[0]
    c_p = torch.gather(costs, 0, (d0 + 1)[None])[0]
    denom = torch.clamp(c_m + c_p - 2.0 * c_0, min=1e-9)
    delta = torch.clamp((c_m - c_p) / (2.0 * denom), -0.5, 0.5)
    disp = torch.where(best_d == d0, best_d + delta, best_d.to(torch.float32))
    return disp, unique_ok


def stereo_bm_disparity(
    left: torch.Tensor,
    right: torch.Tensor,
    num_disparities: int = 48,
    block_size: int = 21,
    prefilter_cap: int = 31,
    texture_threshold: int = 10,
    uniqueness_ratio: int = 15,
) -> torch.Tensor:
    """Dense float32 disparity ``[H, W]`` of the left image; -1 where invalid.

    A pixel is valid when its full window and search range fit
    (``radius <= y < h - radius``, ``D + radius - 1 <= x < w - radius``),
    it passes the uniqueness and texture tests, and its best cost is below
    1e5 (a cost that summed the 1e6 fill of unmatched columns is not)."""
    h, w = left.shape
    radius = block_size // 2
    cap = float(prefilter_cap)
    lpre = _xsobel_prefilter(left, prefilter_cap)
    rpre = _xsobel_prefilter(right, prefilter_cap)

    # right image shifted by d at every candidate: window d of the left-padded
    # right image starts at column D - d
    r_padded = torch.nn.functional.pad(rpre, (num_disparities, 0))
    windows = r_padded.unfold(1, w, 1)                       # [H, D + 1, W]
    shift = num_disparities - torch.arange(num_disparities, device=left.device)
    shifted = windows[:, shift].permute(1, 0, 2)             # [D, H, W]
    ds = torch.arange(num_disparities, device=left.device)[:, None, None]
    xs = torch.arange(w, device=left.device)
    # columns x < d have no right-image counterpart
    diff = torch.where(xs >= ds, torch.abs(lpre - shifted), 1e6)
    costs = box_sum_tree(diff, radius)                       # [D, H, W]

    best_d = torch.argmin(costs, dim=0)                      # first minimum
    best_c = torch.amin(costs, dim=0)
    disp, unique_ok = _subpixel_valid(costs, best_d, best_c, num_disparities,
                                      uniqueness_ratio)
    tex_ok = box_filter(torch.abs(lpre - cap), radius) >= texture_threshold
    ys = torch.arange(h, device=left.device)[:, None]
    inside = (
        (ys >= radius)
        & (ys < h - radius)
        & (xs[None, :] >= num_disparities + radius - 1)
        & (xs[None, :] < w - radius)
    )
    valid = inside & unique_ok & tex_ok & (best_c < 1e5)
    return torch.where(valid, disp, -1.0).to(torch.float32)


def disparity_at(disparity: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Disparity at truncated-int feature coordinates (``disparity.at(y, x)``)."""
    h, w = disparity.shape
    xi = torch.clamp(xy[..., 0].to(torch.int64), 0, w - 1)
    yi = torch.clamp(xy[..., 1].to(torch.int64), 0, h - 1)
    return disparity[yi, xi]


def _check_at(left, right, xy, valid, num_disparities, block_size):
    """Validate ``stereo_bm_at``'s arguments; returns their common device."""
    if left.dim() != 2 or left.dtype != torch.float32 or right.shape != left.shape \
            or right.dtype != torch.float32:
        raise ValueError(f"images must be two [H, W] float32 tensors of one shape, got "
                         f"{tuple(left.shape)} {left.dtype} and "
                         f"{tuple(right.shape)} {right.dtype}")
    if xy.dim() != 2 or xy.shape[1] != 2 or xy.dtype != torch.float32:
        raise ValueError(f"xy must be [N, 2] float32, got {tuple(xy.shape)} {xy.dtype}")
    if tuple(valid.shape) != (xy.shape[0],) or valid.dtype != torch.bool:
        raise ValueError(f"valid must be [{xy.shape[0]}] bool, got "
                         f"{tuple(valid.shape)} {valid.dtype}")
    if len({t.device for t in (left, right, xy, valid)}) != 1:
        raise ValueError(f"stereo_bm_at tensors lie on several devices: "
                         f"{sorted({str(t.device) for t in (left, right, xy, valid)})}")
    if num_disparities < 3 or block_size < 1 or block_size % 2 == 0:
        raise ValueError(f"unsupported num_disparities {num_disparities} or block_size "
                         f"{block_size} (need >= 3 and odd)")
    return left.device


def stereo_bm_at_ref(
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
    """Plain PyTorch version of ``stereo_bm_at``.

    ``compact_slots``: when > 0 and at most that many inputs are valid, match
    exactly ``compact_slots`` slots (valid first, stable order) and scatter
    the results back; otherwise match at full width. Per-feature results do
    not depend on batch position, so both give the same answer.
    """
    _check_at(left, right, xy, valid, num_disparities, block_size)
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


def _kernel():
    from stereo_vo_tpu_torch import cuda_build

    lib = cuda_build.load("stereo_bm_at")
    fn = lib.svo_stereo_bm_at
    if fn.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr, ptr, i32, i32,             # images, h, w
                       ptr, ptr, ptr, i32,             # xy, valid, out, n
                       i32, i32, i32, i32, i32,        # D, block, cap, texture, uniqueness
                       ptr]                            # stream
        fn.restype = ctypes.c_int
    return fn


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
    """StereoBM disparity at feature pixels ``xy [N, 2]`` (float32) of the
    ``[H, W]`` float32 images; -1 where ``valid [N]`` is false or a test
    fails.

    CUDA tensors go through the kernel ``csrc/stereo_bm_at.cu``, one launch
    per call (each adds one to ``stereo_bm_at.launches``); every tensor must
    be contiguous, and ``compact_slots`` changes nothing there, since the
    kernel skips invalid slots itself. CPU tensors go through
    ``stereo_bm_at_ref``, whose ``compact_slots`` gives the same answer.
    """
    dev = _check_at(left, right, xy, valid, num_disparities, block_size)
    if dev.type == "cpu":
        return stereo_bm_at_ref(left, right, xy, valid, num_disparities, block_size,
                                prefilter_cap, texture_threshold, uniqueness_ratio,
                                compact_slots)
    if dev.type != "cuda":
        raise ValueError(f"stereo_bm_at: unsupported device {dev}")
    if not all(t.is_contiguous() for t in (left, right, xy, valid)):
        raise ValueError("stereo_bm_at: every tensor must be contiguous")
    n = xy.shape[0]
    h, w = left.shape
    out = torch.empty(n, dtype=torch.float32, device=dev)
    if n == 0:
        return out
    fn = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(left.data_ptr(), right.data_ptr(), h, w, xy.data_ptr(), valid.data_ptr(),
                out.data_ptr(), n, num_disparities, block_size, prefilter_cap,
                texture_threshold, uniqueness_ratio, stream)
    if rc != 0:
        raise RuntimeError(f"stereo_bm_at kernel launch failed: CUDA error {rc}")
    stereo_bm_at.launches += 1
    return out


stereo_bm_at.launches = 0


def _region_geometry(xi, yi, h, w, num_disparities, block_size):
    """Where the plain version cuts each feature's regions from the
    prefiltered images edge-padded by ``m``: returns ``m``, the region sizes
    ``(ry, rx_l, rx_r)``, the origins ``(ox_l, ox_r, oy)`` (aligned down to 8
    exactly as the reference places them) and the window's and band's
    top-left inside their regions ``(row0, col0_l, col0_r)``."""
    radius = block_size // 2
    band = num_disparities + block_size - 1
    m = num_disparities + radius + 8
    ry = (block_size + 7 + 7) // 8 * 8
    rx_l = ry
    rx_r = (band + 7 + 7) // 8 * 8
    hp, wp = h + 2 * m, w + 2 * m

    def floor8(v):
        return torch.div(v, 8, rounding_mode="floor") * 8

    oy = torch.clamp(floor8(yi - radius + m), 0, hp - ry)
    ox_l = torch.clamp(floor8(xi - radius + m), 0, wp - rx_l)
    ox_r = torch.clamp(floor8(xi - (num_disparities - 1) - radius + m), 0, wp - rx_r)
    row0 = yi + m - oy - radius
    col0_l = xi + m - ox_l - radius
    col0_r = xi + m - ox_r - (num_disparities - 1) - radius
    return m, (ry, rx_l, rx_r), (ox_l, ox_r, oy), (row0, col0_l, col0_r)


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
    """Per-feature BM over every input slot (see ``stereo_bm_at_ref``)."""
    h, w = left.shape
    radius = block_size // 2
    cap = float(prefilter_cap)
    win = block_size
    band = num_disparities + block_size - 1

    lpre = _xsobel_prefilter(left, prefilter_cap)
    rpre = _xsobel_prefilter(right, prefilter_cap)

    # truncated-int lookup coordinates (disparity_at semantics)
    xi = torch.clamp(xy[:, 0].to(torch.int64), 0, w - 1)
    yi = torch.clamp(xy[:, 1].to(torch.int64), 0, h - 1)

    # left window region and right search-band region per feature
    m, (ry, rx_l, rx_r), (ox_l, ox_r, oy), (row0, col0_l, col0_r) = _region_geometry(
        xi, yi, h, w, num_disparities, block_size)
    org_l = torch.stack([ox_l, oy], dim=1).to(torch.int32).contiguous()
    org_r = torch.stack([ox_r, oy], dim=1).to(torch.int32).contiguous()
    lreg = extract_regions_ref(pad_edge(lpre[None], m), org_l, ry, rx_l)[:, 0]
    rreg = extract_regions_ref(pad_edge(rpre[None], m), org_r, ry, rx_r)[:, 0]
    lwin = _take_window(lreg, row0, col0_l, win, win)            # [N, win, win]
    rband = _take_window(rreg, row0, col0_r, win, band)          # [N, win, band]

    # SAD per disparity: the right window for d starts at band offset
    # (d_max - 1) - d; unfold gives offsets 0..d_max-1, flipped to ascending d
    shifted = rband.unfold(2, win, 1)                   # [N, win, d_max, win]
    sads = torch.sum(torch.abs(lwin[:, :, None, :] - shifted), dim=(1, 3))
    sads = torch.flip(sads, dims=(1,)).T                # [D, N]

    best_d = torch.argmin(sads, dim=0)                  # first minimum
    best_c = torch.amin(sads, dim=0)
    disp, unique_ok = _subpixel_valid(sads, best_d, best_c, num_disparities, uniqueness_ratio)
    tex = torch.sum(torch.abs(lwin - cap), dim=(1, 2))
    tex_ok = tex >= texture_threshold
    inside = (
        (yi >= radius)
        & (yi < h - radius)
        & (xi >= num_disparities + radius - 1)
        & (xi < w - radius)
    )
    ok = inside & unique_ok & tex_ok & valid
    return torch.where(ok, disp, -1.0).to(torch.float32)
