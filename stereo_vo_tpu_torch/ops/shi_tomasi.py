"""Shi-Tomasi corner detection, goodFeaturesToTrack semantics (counterpart of
``stereo_vo_tpu/ops/shi_tomasi.py``).

1. min-eigenvalue response: Sobel gradients, 3x3 box-summed structure tensor;
2. quality gate at ``quality_level * max(response)`` and a 3x3 local-max test;
3. greedy min-distance suppression over a candidate pool, run as the same
   parallel fixpoint as the reference (accepted set identical to the
   sequential descending-response sweep): ``greedy_nms``, on the card one
   launch of ``csrc/greedy_nms.cu``; or with ``nms="maxpool"`` a
   windowed-max test over ``min_distance``;
4. the first ``max_corners`` accepted corners into a fixed ``[K, 2]`` array.

Ordering is pinned explicitly: candidates sort by (value desc, flat index
asc), which is what the reference's ``lax.top_k`` gives; ``torch.topk`` does
not promise a tie order.
"""

from __future__ import annotations

import ctypes
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


def greedy_nms_ref(cxy: torch.Tensor, cvalid: torch.Tensor, r2: float) -> torch.Tensor:
    """The greedy fixpoint over candidates ``cxy [C, 2]`` sorted by descending
    response: ``accepted [C]`` bool, the set the sequential sweep keeps with
    squared distance ``r2``. The plain version of ``greedy_nms``: one host
    read per round.

    Candidate i is accepted once every earlier conflicting candidate is
    decided and none was accepted, killed once an earlier conflicting
    candidate is accepted."""
    c = cxy.shape[0]
    d2 = torch.sum((cxy[:, None, :] - cxy[None, :, :]) ** 2, dim=-1)
    ar = torch.arange(c, device=cxy.device)
    earlier = ar[:, None] < ar[None, :]
    conflicts = ((d2 < r2) & earlier & cvalid[:, None] & cvalid[None, :]).to(torch.float32)

    accepted = torch.zeros(c, dtype=torch.bool, device=cxy.device)
    killed = torch.zeros(c, dtype=torch.bool, device=cxy.device)
    still = bool(cvalid.any())
    while still:
        pending = cvalid & ~accepted & ~killed
        blocked = (pending.to(torch.float32) @ conflicts) > 0.0
        by_acc = (accepted.to(torch.float32) @ conflicts) > 0.0
        killed = killed | (pending & by_acc)
        accepted = accepted | (pending & ~by_acc & ~blocked)
        still = bool((cvalid & ~accepted & ~killed).any())
    return accepted


# the kernel runs the fixpoint in one block of this many threads
GREEDY_NMS_MAX = 1024

_nms_fn = None


def _nms_kernel():
    """The kernel's C entry point, built, loaded and typed at first use."""
    global _nms_fn
    if _nms_fn is None:
        from stereo_vo_tpu_torch import cuda_build

        fn = cuda_build.load("greedy_nms").svo_greedy_nms
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _nms_fn = fn
    return _nms_fn


def greedy_nms(cxy: torch.Tensor, cvalid: torch.Tensor, r2: float) -> torch.Tensor:
    """``greedy_nms_ref``'s accepted set. CUDA tensors go through the kernel
    ``csrc/greedy_nms.cu``, the whole fixpoint in one launch with no host
    read (each launch adds one to ``greedy_nms.launches``; at most
    ``GREEDY_NMS_MAX`` candidates, contiguous); CPU tensors through
    ``greedy_nms_ref``."""
    dev = cxy.device
    c = cxy.shape[0]
    if cxy.dim() != 2 or cxy.shape[1] != 2 or cxy.dtype != torch.float32:
        raise ValueError(f"cxy must be [C, 2] float32, got {tuple(cxy.shape)} {cxy.dtype}")
    if tuple(cvalid.shape) != (c,) or cvalid.dtype != torch.bool or cvalid.device != dev:
        raise ValueError(f"cvalid must be [{c}] bool on {dev}, got {tuple(cvalid.shape)} "
                         f"{cvalid.dtype} on {cvalid.device}")
    if dev.type == "cpu":
        return greedy_nms_ref(cxy, cvalid, r2)
    if dev.type != "cuda":
        raise ValueError(f"greedy_nms: unsupported device {dev}")
    if c > GREEDY_NMS_MAX:
        raise ValueError(f"greedy_nms: {c} candidates, the kernel takes at most {GREEDY_NMS_MAX}")
    if not (cxy.is_contiguous() and cvalid.is_contiguous()):
        raise ValueError("greedy_nms: cxy and cvalid must be contiguous")
    accepted = torch.empty(c, dtype=torch.bool, device=dev)
    if c == 0:
        return accepted
    fn = _nms_kernel()
    with torch.cuda.device(dev):
        rc = fn(cxy.data_ptr(), cvalid.data_ptr(), accepted.data_ptr(), c, r2,
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"greedy_nms kernel launch failed: CUDA error {rc}")
    greedy_nms.launches += 1
    return accepted


greedy_nms.launches = 0


def _sort_desc(values: torch.Tensor, k: int):
    """Top ``k`` of a 1-D tensor ordered by (value desc, index asc)."""
    order = torch.sort(-values, stable=True).indices[:k]
    return values[order], order


def _peak_test(img, quality_level, block_size, border, resp):
    """The quality gate and the 3x3 local-maximum test: ``(resp, is_peak,
    window_peaks)``, ``resp`` zero outside the border and ``window_peaks(value,
    mask, radius)`` the windowed-max test that both NMS modes use."""
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

    is_peak = window_peaks(resp, (resp >= thresh) & (resp > 0) & inside, 1)
    return resp, is_peak, window_peaks


def _candidate_pool(resp, is_peak, window_peaks, min_distance, candidates):
    """The greedy sweep's pool: the strongest ``candidates`` peaks after a
    pre-thinning, ``(cxy [C, 2] float32 pixel coordinates, cvals [C])``
    ordered by (value desc, flat index asc), padded with value -1."""
    h, w = resp.shape
    device = resp.device
    radius = max(int(min_distance), 1)
    # pre-thin so the fixed-size pool is spatially representative
    thin_r = max(radius // 4, 1)
    is_peak = window_peaks(resp, is_peak, thin_r)
    masked = torch.where(is_peak, resp, -1.0)
    ys = torch.arange(h, device=device)[:, None]
    xs = torch.arange(w, device=device)[None, :]
    flat_idx = (ys * w + xs).to(torch.float32)

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
    return cxy, cvals


def corner_candidates(
    img: torch.Tensor,
    quality_level: float = 0.1,
    min_distance: float = 30.0,
    block_size: int = 3,
    border: int = 3,
    candidates: int = 1024,
    resp: torch.Tensor = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The candidate pool that ``detect_corners``'s greedy sweep (and so
    ``greedy_nms``) runs on: ``(cxy [C, 2], cvals [C])``, valid where
    ``cvals > 0``."""
    resp, is_peak, window_peaks = _peak_test(img, quality_level, block_size, border, resp)
    return _candidate_pool(resp, is_peak, window_peaks, min_distance, candidates)


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
    w = img.shape[1]
    resp, is_peak, window_peaks = _peak_test(img, quality_level, block_size, border, resp)

    if nms == "maxpool":
        is_corner = window_peaks(resp, is_peak, max(int(min_distance), 1))
        vals, idx = _sort_desc(torch.where(is_corner, resp, -1.0).reshape(-1), max_corners)
        xy = torch.stack([(idx % w).to(torch.float32), (idx // w).to(torch.float32)], dim=-1)
        return xy, vals, vals > 0

    cxy, cvals = _candidate_pool(resp, is_peak, window_peaks, min_distance, candidates)
    cvalid = cvals > 0
    r2 = float(min_distance) * float(min_distance)
    accepted = greedy_nms(cxy, cvalid, r2)
    # cap at max_corners by acceptance rank
    rank = torch.cumsum(accepted.to(torch.int32), dim=0)
    accepted = accepted & (rank <= max_corners)

    order = torch.sort((~accepted).to(torch.uint8), stable=True).indices
    sel = order[:max_corners]
    valid = accepted[sel]
    return cxy[sel], torch.where(valid, cvals[sel], -1.0), valid
