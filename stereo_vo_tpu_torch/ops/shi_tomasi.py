"""Shi-Tomasi corner detection, goodFeaturesToTrack semantics (counterpart of
``stereo_vo_tpu/ops/shi_tomasi.py``).

1. min-eigenvalue response: Sobel gradients, 3x3 box-summed structure tensor;
2. quality gate at ``quality_level * max(response)`` and a 3x3 local-max test;
3. greedy min-distance suppression over a candidate pool of any size, run
   as the same parallel fixpoint as the reference (accepted set identical to
   the sequential descending-response sweep); or with ``nms="maxpool"`` a
   windowed-max test over ``min_distance``;
4. the first ``max_corners`` accepted corners into a fixed ``[K, 2]`` array:
   with greedy NMS, ``greedy_nms`` does 3 and 4 in one launch of
   ``csrc/greedy_nms.cu`` on the card.

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


def greedy_nms_rounds(cxy: torch.Tensor, cvalid: torch.Tensor, r2: float):
    """The greedy fixpoint over candidates ``cxy [C, 2]`` sorted by
    descending response: ``(accepted [C] bool, rounds)``, the set the
    sequential sweep keeps with squared distance ``r2`` and the rounds the
    fixpoint took (the longest suppression chain). One host read per round.

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
    rounds = 0
    still = bool(cvalid.any())
    while still:
        rounds += 1
        pending = cvalid & ~accepted & ~killed
        blocked = (pending.to(torch.float32) @ conflicts) > 0.0
        by_acc = (accepted.to(torch.float32) @ conflicts) > 0.0
        killed = killed | (pending & by_acc)
        accepted = accepted | (pending & ~by_acc & ~blocked)
        still = bool((cvalid & ~accepted & ~killed).any())
    return accepted, rounds


def greedy_nms_ref(cxy: torch.Tensor, cvalid: torch.Tensor, r2: float) -> torch.Tensor:
    """``greedy_nms_rounds``' accepted set: the plain version of
    ``greedy_nms``."""
    return greedy_nms_rounds(cxy, cvalid, r2)[0]


def greedy_nms_pack_ref(cxy: torch.Tensor, cvalid: torch.Tensor, cvals: torch.Tensor,
                        r2: float, max_corners: int):
    """``greedy_nms_ref``'s accepted set capped at its first ``max_corners``
    and packed as ``detect_corners`` returns it: ``(xy [K, 2], response [K],
    valid [K])`` with ``K = min(C, max_corners)``, the capped accepted
    candidates in index order, then the others in index order with response
    -1. The plain version of ``greedy_nms`` with ``cvals``."""
    accepted = greedy_nms_ref(cxy, cvalid, r2)
    # cap at max_corners by acceptance rank
    rank = torch.cumsum(accepted.to(torch.int32), dim=0)
    accepted = accepted & (rank <= max_corners)

    order = torch.sort((~accepted).to(torch.uint8), stable=True).indices
    sel = order[:max_corners]
    valid = accepted[sel]
    return cxy[sel], torch.where(valid, cvals[sel], -1.0), valid


# what the kernel reports when given ``stats``: conflict pairs, the
# candidates whose conflicts went to a bit row, the binning grid's width and
# height in cells, the cell side's float32 bits, and the SM cycles of its
# phases (bounding box and grid, counting sort, pair tests, bit rows and the
# first round, the other rounds, output)
NMS_STATS = ("pairs", "bit_rows", "grid_w", "grid_h", "cell_side_bits", "cycles_grid",
             "cycles_sort", "cycles_pairs", "cycles_first_round", "cycles_rounds",
             "cycles_out")

_nms_fns = None


def _nms_kernel():
    """The kernel's C entry points, the launch and the size of its scratch,
    built, loaded and typed at first use."""
    global _nms_fns
    if _nms_fns is None:
        from stereo_vo_tpu_torch import cuda_build

        lib = cuda_build.load("greedy_nms")
        fn = lib.svo_greedy_nms
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                               ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        size = lib.svo_greedy_nms_scratch_bytes
        size.argtypes = [ctypes.c_int]
        size.restype = ctypes.c_longlong
        _nms_fns = (fn, size)
    return _nms_fns


def greedy_nms(cxy: torch.Tensor, cvalid: torch.Tensor, r2: float,
               cvals: torch.Tensor = None, max_corners: int = None,
               stats: torch.Tensor = None):
    """``greedy_nms_ref``'s accepted set ``[C]``; given ``cvals`` and
    ``max_corners``, ``greedy_nms_pack_ref``'s ``(xy, response, valid)``
    instead. CUDA tensors go through the kernel ``csrc/greedy_nms.cu``: the
    whole fixpoint, and the cap and pack, in one launch with no host read
    (each launch adds one to ``greedy_nms.launches``; any C, contiguous;
    ``stats``, an int64 ``[len(NMS_STATS)]`` tensor on the card, receives
    the kernel's counts). CPU tensors go through the plain versions."""
    dev = cxy.device
    c = cxy.shape[0]
    if cxy.dim() != 2 or cxy.shape[1] != 2 or cxy.dtype != torch.float32:
        raise ValueError(f"cxy must be [C, 2] float32, got {tuple(cxy.shape)} {cxy.dtype}")
    if tuple(cvalid.shape) != (c,) or cvalid.dtype != torch.bool or cvalid.device != dev:
        raise ValueError(f"cvalid must be [{c}] bool on {dev}, got {tuple(cvalid.shape)} "
                         f"{cvalid.dtype} on {cvalid.device}")
    pack = cvals is not None
    if pack != (max_corners is not None):
        raise ValueError("greedy_nms: give both cvals and max_corners, or neither")
    if pack:
        if tuple(cvals.shape) != (c,) or cvals.dtype != torch.float32 or cvals.device != dev:
            raise ValueError(f"cvals must be [{c}] float32 on {dev}, got {tuple(cvals.shape)} "
                             f"{cvals.dtype} on {cvals.device}")
        if max_corners < 0:
            raise ValueError(f"max_corners must be >= 0, got {max_corners}")
    if dev.type == "cpu":
        if stats is not None:
            raise ValueError("greedy_nms: stats are the kernel's, on the card")
        if pack:
            return greedy_nms_pack_ref(cxy, cvalid, cvals, r2, max_corners)
        return greedy_nms_ref(cxy, cvalid, r2)
    if dev.type != "cuda":
        raise ValueError(f"greedy_nms: unsupported device {dev}")
    if not (cxy.is_contiguous() and cvalid.is_contiguous()
            and (not pack or cvals.is_contiguous())):
        raise ValueError("greedy_nms: cxy, cvalid and cvals must be contiguous")
    if stats is not None and (tuple(stats.shape) != (len(NMS_STATS),)
                              or stats.dtype != torch.int64 or stats.device != dev):
        raise ValueError(f"stats must be [{len(NMS_STATS)}] int64 on {dev}")
    if pack:
        k = min(c, max_corners)
        out = (torch.empty(k, 2, dtype=torch.float32, device=dev),
               torch.empty(k, dtype=torch.float32, device=dev),
               torch.empty(k, dtype=torch.bool, device=dev))
        ptrs = (0, out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr())
    else:
        out = torch.empty(c, dtype=torch.bool, device=dev)
        ptrs = (out.data_ptr(), 0, 0, 0)
    if c == 0:
        return out
    fn, scratch_bytes = _nms_kernel()
    scratch = torch.empty(scratch_bytes(c), dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        rc = fn(cxy.data_ptr(), cvalid.data_ptr(), cvals.data_ptr() if pack else 0, *ptrs, c,
                min(max_corners, c) if pack else 0, r2, scratch.data_ptr(),
                0 if stats is None else stats.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"greedy_nms kernel launch failed: CUDA error {rc}")
    greedy_nms.launches += 1
    return out


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
    r2 = float(min_distance) * float(min_distance)
    return greedy_nms(cxy, cvals > 0, r2, cvals, max_corners)
