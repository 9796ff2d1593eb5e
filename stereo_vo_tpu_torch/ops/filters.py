"""Small separable image filters (counterpart of ``stereo_vo_tpu/ops/filters.py``).

Borders are reflect-101 (OpenCV's BORDER_DEFAULT) unless noted. Images are
``[..., H, W]`` float32. Filters are written as the same shifted-add sums as
the reference, tap by tap in the same order, not as ``conv2d``: that keeps the
f32 rounding order identical to the reference and keeps cuDNN's TF32 path out.
"""

from __future__ import annotations

import numpy as np
import torch


def _reflect_index(n: int, r: int, device) -> torch.Tensor:
    """Source indices of a length-``n`` axis padded by ``r`` on both sides with
    reflect-101 borders (``numpy.pad(mode="reflect")``)."""
    idx = torch.arange(-r, n + r, device=device)
    period = 2 * (n - 1) if n > 1 else 1
    idx = torch.remainder(idx, period)
    return torch.where(idx >= n, period - idx, idx)


def _pad_axis(img: torch.Tensor, r: int, dim: int, mode: str) -> torch.Tensor:
    if r == 0:
        return img
    n = img.shape[dim]
    if mode == "edge":
        idx = torch.arange(-r, n + r, device=img.device).clamp(0, n - 1)
    else:
        idx = _reflect_index(n, r, img.device)
    return torch.index_select(img, dim, idx)


def pad_2d(img: torch.Tensor, ry: int, rx: int, mode: str = "reflect") -> torch.Tensor:
    """Pad the two trailing dims (``mode``: ``"reflect"`` = reflect-101, or
    ``"edge"``)."""
    return _pad_axis(_pad_axis(img, ry, -2, mode), rx, -1, mode)


def sep_filter(img: torch.Tensor, ky, kx, mode: str = "reflect") -> torch.Tensor:
    """Separable 2D correlation with 1D taps ``ky`` (rows) then ``kx`` (cols)."""
    ky = np.asarray(ky, np.float32)
    kx = np.asarray(kx, np.float32)
    ry, rx = len(ky) // 2, len(kx) // 2
    p = _pad_axis(img, ry, -2, mode)
    h = img.shape[-2]
    out = 0
    for i in range(len(ky)):
        if ky[i] != 0:
            out = out + float(ky[i]) * p[..., i : i + h, :]
    p = _pad_axis(out, rx, -1, mode)
    w = img.shape[-1]
    res = 0
    for i in range(len(kx)):
        if kx[i] != 0:
            res = res + float(kx[i]) * p[..., :, i : i + w]
    return res


def sobel_x(img: torch.Tensor, mode: str = "reflect") -> torch.Tensor:
    """Sobel d/dx, ksize 3 (smooth [1,2,1] over rows, diff [-1,0,1] over cols)."""
    return sep_filter(img, [1.0, 2.0, 1.0], [-1.0, 0.0, 1.0], mode)


def sobel_y(img: torch.Tensor, mode: str = "reflect") -> torch.Tensor:
    return sep_filter(img, [-1.0, 0.0, 1.0], [1.0, 2.0, 1.0], mode)


def scharr_x(img: torch.Tensor, mode: str = "reflect") -> torch.Tensor:
    """Scharr d/dx as used by OpenCV's LK spatial gradients (divided by 32)."""
    return sep_filter(img, [3.0, 10.0, 3.0], [-1.0, 0.0, 1.0], mode) / 32.0


def scharr_y(img: torch.Tensor, mode: str = "reflect") -> torch.Tensor:
    return sep_filter(img, [-1.0, 0.0, 1.0], [3.0, 10.0, 3.0], mode) / 32.0


def box_filter(img: torch.Tensor, radius: int, mode: str = "reflect") -> torch.Tensor:
    """Unnormalized (2r+1)^2 box sum, small radii only (separable tap sums).

    The reference's cumulative-sum branch for radius > 3 serves the dense
    StereoBM, which is not ported yet."""
    if radius > 3:
        raise NotImplementedError(
            "box_filter: radius > 3 serves the dense StereoBM, not ported yet (ROADMAP Queue 1, item 15)")
    ones = np.ones(2 * radius + 1, np.float32)
    return sep_filter(img, ones, ones, mode)


def max_filter(img: torch.Tensor, radius: int) -> torch.Tensor:
    """(2r+1)^2 sliding max with -inf borders, separable log-depth doubling."""
    out = img
    for dim in (-2, -1):
        acc = out
        n = out.shape[dim]
        cover = 0
        shift = 1
        while cover < radius:
            s = min(shift, radius - cover)
            fill_shape = list(acc.shape)
            fill_shape[dim] = s
            fill = torch.full(fill_shape, -float("inf"), dtype=acc.dtype, device=acc.device)
            p = torch.cat([fill, acc, fill], dim=dim)
            lo = p.narrow(dim, 0, n)
            hi = p.narrow(dim, 2 * s, n)
            acc = torch.maximum(acc, torch.maximum(lo, hi))
            cover += s
            shift = 2 * cover + 1
        out = acc
    return out
