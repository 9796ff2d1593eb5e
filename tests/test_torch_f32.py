"""The port's float32 arithmetic as the reference's compiled code rounds it
(``stereo_vo_tpu_torch/core/f32.py``), against exact rounding in numpy.

``sqrt_f32`` must be the correctly rounded square root (XLA's; PyTorch's CPU
root is off by one ulp at some inputs), and ``tap_sum`` must round a
weighted sum as a chain of fused multiply-adds does.
"""

from fractions import Fraction

import numpy as np
import torch

from stereo_vo_tpu_torch.core.f32 import fma_f32, sqrt_f32, tap_sum


def _rounded(values) -> np.ndarray:
    """Exact rationals rounded to the nearest float32, ties to even."""
    out = []
    for v in values:
        r = np.float32(float(v))
        best = None
        for c in (np.nextafter(r, np.float32(-np.inf)), r, np.nextafter(r, np.float32(np.inf))):
            d = abs(Fraction(float(c)) - v)
            if best is None or d < best[0] or (d == best[0] and int(c.view(np.int32)) % 2 == 0):
                best = (d, c)
        out.append(best[1])
    return np.array(out, np.float32)


def test_sqrt_f32_is_correctly_rounded(rng):
    x = np.concatenate([
        rng.random(200_000).astype(np.float32) * 1e6,
        rng.random(50_000).astype(np.float32) * 1e-30,
        (rng.random(50_000) * 2.0 ** rng.integers(-120, 120, 50_000)).astype(np.float32),
        np.array([0.0, 1.0, 2.0, 4.0, 1e-45, 3.4e38, np.inf], np.float32),
    ])
    # a float64 root of a float32 rounds correctly to float32 (53 >= 2 * 24 + 2)
    want = np.sqrt(x.astype(np.float64)).astype(np.float32)
    np.testing.assert_array_equal(sqrt_f32(torch.from_numpy(x)).numpy(), want)
    special = sqrt_f32(torch.tensor([-1.0, float("nan"), -0.0]))
    assert torch.isnan(special[:2]).all() and special[2] == 0.0


def test_tap_sum_rounds_as_fused_multiply_adds(rng):
    n = 2000
    xs = [rng.uniform(-300, 300, n).astype(np.float32) for _ in range(3)]
    weights = (3.0, 10.0, 0.375)
    got = tap_sum([(w, torch.from_numpy(x)) for w, x in zip(weights, xs)]).numpy()
    # fma(x0, w0, round(w1 x1)), then fma(x2, w2, that), each rounded once
    acc = _rounded([Fraction(float(a)) * Fraction(weights[0])
                    + Fraction(float(np.float32(b * np.float32(weights[1]))))
                    for a, b in zip(xs[0], xs[1])])
    want = _rounded([Fraction(float(c)) * Fraction(weights[2]) + Fraction(float(a))
                     for a, c in zip(acc, xs[2])])
    np.testing.assert_array_equal(got, want)
    # a +-1 weight is no product: the second term's product fuses instead
    got = tap_sum([(-1.0, torch.from_numpy(xs[0])), (3.0, torch.from_numpy(xs[1]))]).numpy()
    np.testing.assert_array_equal(
        got, fma_f32(torch.from_numpy(xs[1]), 3.0, torch.from_numpy(-xs[0])).numpy())
