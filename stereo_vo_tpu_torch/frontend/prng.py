"""Counter-based threefry2x32 random numbers, bit for bit those of
``jax.random`` (the role ``jax.random`` plays for ``stereo_vo_tpu``).

The reference draws PnP-RANSAC's minimal samples with ``jax.random``
(``stereo_vo_tpu/frontend/pnp.py::pnp_ransac``): ``PRNGKey(frame index)``,
``split`` into one key per hypothesis, and per key ``choice(..., replace=False,
p=valid / n_valid)``, which is the Gumbel top-k trick. Every step of that is
integer and float32 arithmetic, so the port recomputes it exactly:

- ``threefry2x32``: 20 rounds, rotations (13, 15, 26, 6) and (17, 29, 16, 24),
  the key schedule ``k1 ^ k2 ^ 0x1BD11BDA`` injected after every 4 rounds;
- ``prng_key(seed) = (0, seed)`` for a uint32 seed;
- ``split(key, n)``: row i is ``threefry2x32(key, (0, i))``;
- ``random_bits(key, n)``: ``b1 ^ b2`` of ``threefry2x32(key, (0, j))``;
- ``gumbel``: a uniform on ``[tiny, 1)`` from the top 23 bits, then
  ``-log(-log(u))`` with ``log_f32``, the log as XLA's CPU code rounds it.
  There are only 2^23 such uniforms, so ``gumbel_table`` holds the value of
  each, built once per device, and a draw looks its values up.

These are JAX's defaults as of JAX 0.9.0: ``jax_threefry_partitionable=True``
(counters are a flat iota split into 32-bit halves) and gumbel mode ``low``.
``tests/test_torch_pnp.py`` holds ``split``, ``random_bits``, the whole
Gumbel table and the drawn indices to JAX bitwise.

torch has no full uint32 arithmetic, so words are int64 tensors masked to 32
bits. Every function runs on the device of its tensor arguments with the
same result on any device: integer ops, float32 products and sums, and
float64 ones that emulate fused multiply-adds exactly.
"""

from __future__ import annotations

import functools
import struct

import torch

from stereo_vo_tpu_torch.core.f32 import fma_f32

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
FLOAT32_TINY = float(torch.finfo(torch.float32).tiny)


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor):
    """The threefry2x32 hash of counters ``(x1, x2)`` under key ``(k1, k2)``,
    broadcast elementwise; every argument and result is an int64 tensor of
    32-bit words.

    ``x2`` is masked to 32 bits after every step, since its rotation needs a
    clean word; ``x1`` only adds and feeds the xor into ``x2``, so its bits
    above 32 (a few carries, far from overflow) are dropped once at the end."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = x1 + ks[0]
    x2 = (x2 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = x1 + x2
            x2 = (((x2 << r) | (x2 >> (32 - r))) ^ x1) & MASK32
        x1 = x1 + ks[(i + 1) % 3]
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x1 & MASK32, x2


def prng_key(seed, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a uint32 seed: ``[2]`` int64 words
    ``(0, seed)``, made on ``device`` without a host-to-device copy. ``seed``
    is a Python int or a 0-d integer tensor (then on ``device``, and read
    as uint32, as the reference's ``frame_idx.astype(uint32)``)."""
    if isinstance(seed, torch.Tensor):
        word = seed.to(torch.int64) & MASK32
    else:
        word = int(seed) & MASK32
    return torch.arange(2, dtype=torch.int64, device=device) * word


def split(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.split(key, n)``: ``[n, 2]`` keys."""
    i = torch.arange(n, dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32(key[0], key[1], torch.zeros_like(i), i)
    return torch.stack([b1, b2], dim=1)


def random_bits(keys: torch.Tensor, n: int) -> torch.Tensor:
    """32 random bits per element: ``jax.random.bits(key, (n,))`` for each
    key of ``keys [..., 2]``, as ``[..., n]`` int64 words."""
    j = torch.arange(n, dtype=torch.int64, device=keys.device)
    b1, b2 = threefry2x32(keys[..., 0:1], keys[..., 1:2], torch.zeros_like(j), j)
    return b1 ^ b2


def _f32(x: float) -> float:
    """``x`` rounded to float32."""
    return struct.unpack("f", struct.pack("f", x))[0]


# Cephes logf: sqrt(1/2), p0..p8 of the polynomial, and ln 2 split in q1 + q2
_SQRTHF = _f32(0.707106781186547524)
_LOG_P = tuple(_f32(c) for c in (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
                                 -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
                                 2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1))
_LOG_Q1 = _f32(-2.12194440e-4)
_LOG_Q2 = _f32(0.693359375)


def log_f32(x: torch.Tensor) -> torch.Tensor:
    """Natural log of float32 ``x``, rounded as XLA's CPU backend rounds it.

    The libm ``logf`` behind ``torch.log`` and XLA's vectorized Cephes
    polynomial differ by one ulp at about one input in seven, and the Gumbel
    top-k draw can turn on one ulp, so the draw needs XLA's own arithmetic:
    the same float32 products and sums in the same order, fused into
    multiply-adds where XLA's x86 code fuses them (it compiles with FMA
    contraction on). Zero and subnormals give ``-inf``, ``+inf`` itself
    and a negative input ``nan``."""
    xc = torch.clamp_min(x, FLOAT32_TINY)
    bits = xc.view(torch.int32)
    e = ((bits >> 23) - 126).to(torch.float32)                # exponent + 1
    m = ((bits & 0x807FFFFF) | 0x3F000000).view(torch.float32)  # [0.5, 1)
    low = m < _SQRTHF
    e = e - low.to(torch.float32)
    xm = (m - 1.0) + torch.where(low, m, torch.zeros_like(m))
    z = xm * xm
    z3 = z * xm
    p = _LOG_P
    a = fma_f32(fma_f32(xm, p[0], p[1]), xm, p[2])
    b = fma_f32(fma_f32(xm, p[3], p[4]), xm, p[5])
    c = fma_f32(fma_f32(xm, p[6], p[7]), xm, p[8])
    y = fma_f32(fma_f32(fma_f32(a, z3, b), z3, c), z3, e * _LOG_Q1)
    # 0.5 z and e q2 (e an integer, q2 nine bits) are exact: no fusion needed
    out = ((xm - z * 0.5) + y) + e * _LOG_Q2
    out = torch.where((x < 0) | torch.isnan(x), float("nan"), out)
    # XLA's CPU code treats subnormals as zero
    out = torch.where(torch.abs(x) < FLOAT32_TINY, float("-inf"), out)
    return torch.where(x == float("inf"), float("inf"), out)


def uniform(mant: torch.Tensor) -> torch.Tensor:
    """``jax.random.uniform(minval=tiny, maxval=1)`` from the top 23 random
    bits ``mant``: ``[1, 2)`` from the mantissa, shifted to ``[tiny, 1)``."""
    f = (mant | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp_min(f * (1.0 - FLOAT32_TINY) + FLOAT32_TINY, FLOAT32_TINY)


_TABLE_CHUNK = 2**19


def gumbel_table(device) -> torch.Tensor:
    """``-log(-log(u))`` for each of the 2^23 uniforms ``u``, indexed by its
    mantissa bits: ``[2^23]`` float32 on ``device`` (32 MB), built once per
    device, in chunks to bound the temporaries."""
    return _gumbel_table(str(device))


@functools.lru_cache(maxsize=None)
def _gumbel_table(device: str) -> torch.Tensor:
    return torch.cat([
        -log_f32(-log_f32(uniform(torch.arange(
            lo, lo + _TABLE_CHUNK, dtype=torch.int64, device=device))))
        for lo in range(0, 2**23, _TABLE_CHUNK)])


def log_inverse_counts(n_max: int, device) -> torch.Tensor:
    """``log_f32(1 / max(n, 1))`` for ``n = 0..n_max``: ``[n_max + 1]``
    float32 on ``device``, built once per size and device."""
    return _log_inverse_counts(n_max, str(device))


@functools.lru_cache(maxsize=None)
def _log_inverse_counts(n_max: int, device: str) -> torch.Tensor:
    n = torch.arange(n_max + 1, dtype=torch.float32, device=device).clamp_min(1.0)
    return log_f32(torch.ones_like(n) / n)


def gumbel(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.gumbel(key, (n,), float32)`` (mode ``low``) for each key
    of ``keys [..., 2]``: ``[..., n]`` float32, looked up in
    ``gumbel_table``."""
    return gumbel_table(keys.device)[random_bits(keys, n) >> 9]
