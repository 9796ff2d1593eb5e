"""Float32 arithmetic rounded as the reference's compiled code rounds it.

The reference runs under ``jax.jit``; XLA's CPU backend compiles each fused
loop with multiply-add contraction on and a correctly rounded square root.
Two consequences reach the port's results:

- a product that feeds an add in the same fused loop is not rounded: the pair
  becomes one fused multiply-add. LLVM's combiner fuses ``a * b + c`` into
  ``fma(a, b, c)`` when the product has no other use, and of ``a * b + c *
  d`` it fuses the product that comes first in XLA's code and rounds the
  other (which one, read from the code XLA dumps with
  ``XLA_FLAGS=--xla_dump_to=...``: a filter's first tap, the box filter's
  middle row). ``fma_f32`` computes such a pair, and ``tap_sum`` a
  left-to-right sum of weighted terms as XLA's code fuses it;
- ``torch.sqrt`` on the CPU is not correctly rounded (its vectorized float32
  and float64 roots are off by one ulp at some inputs, and which inputs
  depends on the buffer's alignment), while XLA's is. ``sqrt_f32`` is.

Each function runs on the device of its tensors and gives the same bits on the
CPU and on CUDA: it uses only float32 and float64 products and sums, which
both round correctly, and square roots corrected to the correctly rounded one
(CUDA's float32 root already is).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch


def _f64(x):
    return x.to(torch.float64) if isinstance(x, torch.Tensor) else x


def fma_f32(a: torch.Tensor, b, c) -> torch.Tensor:
    """``a * b + c`` for a float32 tensor ``a`` and float32 tensors or
    float32 values ``b``, ``c``, rounded once to float32, as a fused
    multiply-add instruction rounds it.

    The product is exact in float64; the float64 sum is made round-to-odd
    from its exact error (TwoSum), and round-to-odd at 53 bits followed by
    round-to-nearest at 24 bits is the correctly rounded result."""
    p = a.to(torch.float64) * _f64(b)
    c = _f64(c)
    s = p + c
    bp = s - c
    err = (p - bp) + (c - (s - bp))
    # inexact with an even last bit: step to the odd neighbour toward the sum
    even = (err != 0) & ((s.view(torch.int64) & 1) == 0)
    return torch.where(even, torch.nextafter(s, err * float("inf")), s).to(torch.float32)


def sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root of a float32 tensor.

    PyTorch's float64 root is not correctly rounded on the CPU either, so it
    only gives a candidate ``r`` within one ulp; ``r`` then steps to a
    neighbour when ``x`` lies beyond the square of the midpoint between them.
    Midpoints have 25 bits, so their squares are exact in float64, and no
    float32 ``x`` is such a square, so there are no ties. Zero, infinity,
    NaN and negative inputs give what ``torch.sqrt`` gives. On CUDA
    ``torch.sqrt`` is IEEE's correctly rounded root (``chip_smoke.py`` phase
    4 holds it against this one), so a CUDA tensor takes it directly."""
    if x.device.type == "cuda":
        return torch.sqrt(x)
    x64 = x.to(torch.float64)
    r = torch.sqrt(x64).to(torch.float32)
    up = torch.nextafter(r, torch.full_like(r, float("inf")))
    down = torch.nextafter(r, torch.zeros_like(r))
    r64 = r.to(torch.float64)
    m_up = (r64 + up.to(torch.float64)) * 0.5
    m_down = (r64 + down.to(torch.float64)) * 0.5
    r = torch.where(x64 > m_up * m_up, up, torch.where(x64 < m_down * m_down, down, r))
    return torch.where((x > 0) & torch.isfinite(x), r, torch.sqrt(x))


def _exact_scale(w: float) -> bool:
    """``w * x`` is exact for every float32 ``x`` (short of overflow and
    underflow): ``w`` is zero or a signed power of two."""
    return w == 0.0 or abs(math.frexp(w)[0]) == 0.5


def _fma_scale(x: torch.Tensor, w: float, acc: torch.Tensor) -> torch.Tensor:
    """``x * w + acc`` with the constant weight ``w``, rounded once; a weight
    that scales exactly needs no fused operation."""
    if _exact_scale(w):
        return acc + x * w
    return fma_f32(x, w, acc)


def tap_sum(terms: Sequence[Tuple[float, torch.Tensor]]) -> torch.Tensor:
    """``w0 * x0 + w1 * x1 + w2 * x2 + ...`` summed left to right, as XLA's
    CPU code computes it: each add fuses its product into the running sum,
    and the first add, of two products, fuses the first and rounds the
    second. A weight of +-1 is no product there (``x`` or ``-x``)."""
    (w0, x0) = terms[0]
    if len(terms) == 1:
        return x0 * w0
    (w1, x1) = terms[1]
    if abs(w0) == 1.0:
        acc = _fma_scale(x1, w1, x0 * w0)
    else:
        acc = _fma_scale(x0, w0, x1 * w1)
    for w, x in terms[2:]:
        acc = _fma_scale(x, w, acc)
    return acc
