"""Small separable image filters (counterpart of ``stereo_vo_tpu/ops/filters.py``).

Borders are reflect-101 (OpenCV's BORDER_DEFAULT) unless noted. Images are
``[..., H, W]`` float32. Filters are written as the same shifted-add sums as
the reference, tap by tap in the same order, not as ``conv2d``: that keeps the
f32 rounding order identical to the reference and keeps cuDNN's TF32 path out.
Each tap's product is fused into the running sum as XLA's compiled code fuses
it (``core/f32.py::tap_sum``), so the pyramid's 6/16 tap and Scharr's 3 and
10 round as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from vobench.reference.core.f32 import fma_f32, tap_sum


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
    out = tap_sum([(float(ky[i]), p[..., i : i + h, :]) for i in range(len(ky)) if ky[i] != 0])
    p = _pad_axis(out, rx, -1, mode)
    w = img.shape[-1]
    return tap_sum([(float(kx[i]), p[..., :, i : i + w]) for i in range(len(kx)) if kx[i] != 0])


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
    """Unnormalized (2r+1)^2 box sum.

    Small radii are separable tap sums; larger ones (the dense StereoBM's
    21x21 texture window) read four corners of an integral image, as the
    reference does. The integral image sums the whole padded image, so on
    general float input its rounding grows with the image's total; on
    integer-valued input below 2^24 in total it is exact."""
    k = 2 * radius + 1
    if radius <= 3:
        ones = np.ones(k, np.float32)
        return sep_filter(img, ones, ones, mode)
    p = pad_2d(img, radius, radius, mode)
    ii = torch.cumsum(torch.cumsum(p, dim=-2), dim=-1)
    ii = torch.nn.functional.pad(ii, (1, 0, 1, 0))       # leading zero row and column
    h, w = img.shape[-2:]
    return (
        ii[..., k : k + h, k : k + w]
        - ii[..., 0:h, k : k + w]
        - ii[..., k : k + h, 0:w]
        + ii[..., 0:h, 0:w]
    )


def box_filter_of_product(u: torch.Tensor, v: torch.Tensor, radius: int,
                          mode: str = "reflect") -> torch.Tensor:
    """``box_filter(u * v, radius)`` for ``radius <= 3`` as XLA's code
    computes it when the products share the row pass's fused loop: the first
    add, of the first two rows' products, fuses the second and rounds the
    first (LLVM swaps its operands), and each later add fuses its row's
    product into the running sum; the column pass adds."""
    if radius > 3:
        raise ValueError(f"radius {radius} > 3: box_filter sums an integral image")
    k = 2 * radius + 1
    pu, pv = _pad_axis(u, radius, -2, mode), _pad_axis(v, radius, -2, mode)
    h = u.shape[-2]
    rows = [(pu[..., i : i + h, :], pv[..., i : i + h, :]) for i in range(k)]
    acc = rows[0][0] * rows[0][1]
    for a, b in rows[1:]:
        acc = fma_f32(a, b, acc)
    p = _pad_axis(acc, radius, -1, mode)
    w = u.shape[-1]
    return tap_sum([(1.0, p[..., :, i : i + w]) for i in range(k)])


def sliding_sum(padded: torch.Tensor, k: int, dim: int) -> torch.Tensor:
    """Sum over every length-``k`` window along ``dim``.

    ``padded`` carries ``k - 1`` extra elements along ``dim``; entry ``i`` of
    the output sums ``padded[i : i + k]``. Built by doubling (sums of 1, 2,
    4, ... elements, then the binary digits of ``k``), so each output sums
    only its own window: a huge value outside the window cannot round it."""
    n_out = padded.shape[dim] - k + 1
    sums = {1: padded}
    c = 1
    while c * 2 <= k:
        a = sums[c]
        n = a.shape[dim]
        sums[c * 2] = a.narrow(dim, 0, n - c) + a.narrow(dim, c, n - c)
        c *= 2
    out = None
    off = 0
    for c in sorted(sums, reverse=True):
        if k & c:
            piece = sums[c].narrow(dim, off, n_out)
            out = piece if out is None else out + piece
            off += c
    return out


def box_sum_tree(img: torch.Tensor, radius: int, mode: str = "reflect") -> torch.Tensor:
    """(2r+1)^2 box sum as two separable sliding sums (see ``sliding_sum``)."""
    k = 2 * radius + 1
    p = pad_2d(img, radius, radius, mode)
    return sliding_sum(sliding_sum(p, k, dim=-2), k, dim=-1)


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
