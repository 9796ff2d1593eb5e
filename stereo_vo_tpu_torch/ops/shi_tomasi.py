"""Shi-Tomasi corner detection, goodFeaturesToTrack semantics (counterpart of
``stereo_vo_tpu/ops/shi_tomasi.py``).

1. min-eigenvalue response: Sobel gradients, 3x3 box-summed structure tensor;
2. quality gate at ``quality_level * max(response)`` and a 3x3 local-max test;
3. greedy min-distance suppression over a candidate pool, run as the same
   parallel fixpoint as the reference (accepted set identical to the
   sequential descending-response sweep), or with ``nms="maxpool"`` a
   windowed-max test over ``min_distance``;
4. the first ``max_corners`` accepted corners into a fixed ``[K, 2]`` array.

Ordering is pinned explicitly: candidates sort by (value desc, flat index
asc), which is what the reference's ``lax.top_k`` gives; ``torch.topk`` does
not promise a tie order.
"""

from __future__ import annotations

from typing import Tuple

import torch

from stereo_vo_tpu_torch.core.f32 import fma_f32, sqrt_f32
from stereo_vo_tpu_torch.ops.filters import box_filter_of_product, max_filter, sobel_x, sobel_y


def min_eig_response(img: torch.Tensor, block_size: int = 3) -> torch.Tensor:
    """Per-pixel Shi-Tomasi response (cv::cornerMinEigenVal, relative scale),
    bit for bit the reference's under ``jax.jit`` on the CPU, single image
    or ``[K, H, W]`` stack: XLA's code fuses the gradient products into the
    box filter's row sums, computes the discriminant ``(a - c)^2 + (4 b) b``
    as ``fma(b, 4 b, (a - c)^2)`` and takes a correctly rounded square
    root."""
    img = img.to(torch.float32)
    ix = sobel_x(img)
    iy = sobel_y(img)
    r = block_size // 2
    a = box_filter_of_product(ix, ix, r)
    b = box_filter_of_product(ix, iy, r)
    c = box_filter_of_product(iy, iy, r)
    d = a - c
    return ((a + c) - sqrt_f32(fma_f32(b, 4.0 * b, d * d))) * 0.5


def _inside_mask(h: int, w: int, border: int, device) -> torch.Tensor:
    ys = torch.arange(h, device=device)[:, None]
    xs = torch.arange(w, device=device)[None, :]
    return (ys >= border) & (ys < h - border) & (xs >= border) & (xs < w - border)


def count_quality_peaks(
    img: torch.Tensor, quality_level: float = 0.1, block_size: int = 3,
    border: int = 3, resp: torch.Tensor = None,
) -> torch.Tensor:
    """Number of 3x3-local-max responses above the quality threshold: the
    every-frame stand-in for the "fewer than 4 detections" bail."""
    h, w = img.shape[-2:]
    if resp is None:
        resp = min_eig_response(img, block_size)
    inside = _inside_mask(h, w, border, resp.device)
    resp = torch.where(inside, resp, 0.0)
    thresh = torch.amax(resp, dim=(-2, -1), keepdim=True) * quality_level
    localmax3 = max_filter(resp, 1)
    is_peak = (resp >= localmax3) & (resp >= thresh) & (resp > 0)
    return torch.sum(is_peak.to(torch.int32), dim=(-2, -1))


def _sort_desc(values: torch.Tensor, k: int):
    """Top ``k`` of a 1-D tensor ordered by (value desc, index asc)."""
    order = torch.sort(-values, stable=True).indices[:k]
    return values[order], order


def detect_corners(
    img: torch.Tensor,
    max_corners: int = 300,
    quality_level: float = 0.1,
    min_distance: float = 30.0,
    block_size: int = 3,
    border: int = 3,
    nms: str = "greedy",
    candidates: int = 1024,
    resp: torch.Tensor = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Detect corners; returns ``(xy [K, 2] float32, response [K], valid [K])``.

    ``nms``: ``"greedy"`` is goodFeaturesToTrack's descending-response sweep
    over the top ``candidates`` peaks; ``"maxpool"`` keeps a peak only if it
    is the maximum within ``min_distance`` (ties to the lowest flat index),
    then takes the ``max_corners`` strongest, which gives fewer corners."""
    if nms not in ("greedy", "maxpool"):
        raise ValueError(f"nms must be 'greedy' or 'maxpool', got {nms!r}")
    h, w = img.shape
    device = img.device
    if resp is None:
        resp = min_eig_response(img, block_size)

    inside = _inside_mask(h, w, border, device)
    resp = torch.where(inside, resp, 0.0)
    thresh = torch.amax(resp) * quality_level

    ys = torch.arange(h, device=device)[:, None]
    xs = torch.arange(w, device=device)[None, :]
    flat_idx = (ys * w + xs).to(torch.float32)
    neg_inf = -float("inf")

    def window_peaks(value, mask, radius):
        """Max of ``value`` within ``radius`` among ``mask`` pixels, ties to the
        lowest flat index."""
        v = torch.where(mask, value, neg_inf)
        is_max = mask & (v >= max_filter(v, radius))
        neg_idx = torch.where(is_max, -flat_idx, neg_inf)
        return is_max & (neg_idx >= max_filter(neg_idx, radius))

    # 3x3 local maximum + quality gate
    is_peak = window_peaks(resp, (resp >= thresh) & (resp > 0) & inside, 1)

    radius = max(int(min_distance), 1)
    if nms == "maxpool":
        is_corner = window_peaks(resp, is_peak, radius)
        vals, idx = _sort_desc(torch.where(is_corner, resp, -1.0).reshape(-1), max_corners)
        xy = torch.stack([(idx % w).to(torch.float32), (idx // w).to(torch.float32)], dim=-1)
        return xy, vals, vals > 0

    # pre-thin so the fixed-size pool is spatially representative
    thin_r = max(radius // 4, 1)
    is_peak = window_peaks(resp, is_peak, thin_r)
    masked = torch.where(is_peak, resp, -1.0)

    # per-tile maximum (tiles of side thin_r + 1 hold at most one peak)
    t = thin_r + 1
    hp_, wp_ = -h % t, -w % t
    padded = torch.nn.functional.pad(masked, (0, wp_, 0, hp_), value=-1.0)
    pidx = torch.nn.functional.pad(flat_idx, (0, wp_, 0, hp_), value=0.0)
    th_, tw_ = padded.shape[0] // t, padded.shape[1] // t
    tiles = padded.reshape(th_, t, tw_, t).permute(0, 2, 1, 3).reshape(th_, tw_, t * t)
    tidx = pidx.reshape(th_, t, tw_, t).permute(0, 2, 1, 3).reshape(th_, tw_, t * t)
    arg = torch.argmax(tiles, dim=-1, keepdim=True)
    tile_val = torch.gather(tiles, -1, arg)[..., 0].reshape(-1)
    tile_idx = torch.gather(tidx, -1, arg)[..., 0].reshape(-1)

    cvals, csel = _sort_desc(tile_val, min(candidates, th_ * tw_))
    cidx = tile_idx[csel].to(torch.int64)
    if candidates > th_ * tw_:  # keep the static [candidates] shape
        pad_n = candidates - th_ * tw_
        cvals = torch.cat([cvals, torch.full((pad_n,), -1.0, dtype=cvals.dtype, device=device)])
        cidx = torch.cat([cidx, torch.zeros((pad_n,), dtype=cidx.dtype, device=device)])
    cxy = torch.stack([(cidx % w).to(torch.float32), (cidx // w).to(torch.float32)], dim=-1)
    cvalid = cvals > 0
    r2 = float(min_distance) * float(min_distance)

    # parallel greedy fixpoint: candidate i is accepted once every earlier
    # conflicting candidate is decided and none was accepted, killed once an
    # earlier conflicting candidate is accepted
    d2 = torch.sum((cxy[:, None, :] - cxy[None, :, :]) ** 2, dim=-1)
    ar = torch.arange(candidates, device=device)
    earlier = ar[:, None] < ar[None, :]
    conflicts = ((d2 < r2) & earlier & cvalid[:, None] & cvalid[None, :]).to(torch.float32)

    accepted = torch.zeros(candidates, dtype=torch.bool, device=device)
    killed = torch.zeros(candidates, dtype=torch.bool, device=device)
    still = bool(cvalid.any())
    while still:
        pending = cvalid & ~accepted & ~killed
        blocked = (pending.to(torch.float32) @ conflicts) > 0.0
        by_acc = (accepted.to(torch.float32) @ conflicts) > 0.0
        killed = killed | (pending & by_acc)
        accepted = accepted | (pending & ~by_acc & ~blocked)
        still = bool((cvalid & ~accepted & ~killed).any())
    # cap at max_corners by acceptance rank
    rank = torch.cumsum(accepted.to(torch.int32), dim=0)
    accepted = accepted & (rank <= max_corners)

    order = torch.sort((~accepted).to(torch.uint8), stable=True).indices
    sel = order[:max_corners]
    valid = accepted[sel]
    return cxy[sel], torch.where(valid, cvals[sel], -1.0), valid
