"""Parity of PnP-RANSAC with the JAX package: its minimal samples, and the
solver with the reference's samples injected.

The reference draws its hypotheses with ``jax.random``; the tests rebuild
those indices with the same calls (``torch_port_helpers.jax_pnp_indices``).
The port's draw (``sample_hypotheses`` over ``frontend/prng.py``) must equal
them bitwise; so must its threefry keys and bits, and its log on every
uniform the draw can produce. The solver gets the reference's indices
(``pnp_ransac_core``). Tolerance: pose within 1e-4 (quaternion and
translation components, translations of a few metres) and identical inlier
masks. Both packages polish the winning hypothesis with the same GN
iterations; what differs is f32 rounding in the 12x12 null-vector solve and
the 6x6 LAPACK solves.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_vo_tpu.core.camera import CameraInfo as JCameraInfo
from stereo_vo_tpu.core.config import FrontendConfig as JFrontendConfig
from stereo_vo_tpu.core.geometry import quat_to_rotmat
from stereo_vo_tpu.frontend import pnp as jpnp

from stereo_vo_tpu_torch.core.config import FrontendConfig
from stereo_vo_tpu_torch.frontend import pnp as tpnp
from stereo_vo_tpu_torch.frontend import prng

from torch_port_helpers import (
    assert_close,
    assert_equal,
    jax_pnp_indices,
    jax_pnp_indices_batch,
    port_camera,
    to_jax,
    to_torch,
)

JCAM = JCameraInfo(focal=718.856, cx=607.1928, cy=185.2157, baseline=0.537)
POSE_TOL = 1e-4
JCFG = JFrontendConfig()
_jax_pnp = jax.jit(lambda p3, uv, valid, prev, seed: jpnp.pnp_ransac(
    p3, uv, valid, JCAM, prev, seed, JCFG))
_jax_dlt = jax.jit(jax.vmap(jpnp._dlt_pose))


def _problem(rng, n=200, outlier_frac=0.2, noise_px=0.5):
    """World points seen by a camera at a random pose, with pixel noise,
    gross outliers and invalid slots."""
    yaw = rng.uniform(-0.2, 0.2)
    q = np.array([np.cos(yaw / 2), 0.0, np.sin(yaw / 2), 0.0])
    t = rng.normal(size=3) * [0.5, 0.1, 1.0]
    pose = np.concatenate([q, t]).astype(np.float32)
    p_cam = np.stack([rng.uniform(-12, 12, n), rng.uniform(-3, 3, n),
                      rng.uniform(5, 40, n)], 1)
    r = np.asarray(quat_to_rotmat(to_jax(q)))
    p_world = (p_cam - t) @ r                           # R^T (p_cam - t)
    uv = p_cam[:, :2] / p_cam[:, 2:3] * JCAM.focal + [JCAM.cx, JCAM.cy]
    uv += rng.normal(size=uv.shape) * noise_px
    out = rng.random(n) < outlier_frac
    uv[out] += rng.uniform(-80, 80, size=(out.sum(), 2))
    valid = rng.random(n) < 0.9
    return (p_world.astype(np.float32), uv.astype(np.float32), valid, pose)


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_pnp_matches_reference_with_injected_samples(rng, seed):
    p3, uv, valid, pose_true = _problem(rng)
    # warm start: the previous frame's pose, a little off
    prev = pose_true.copy()
    prev[4:] += [0.3, -0.05, 0.6]
    want = _jax_pnp(to_jax(p3), to_jax(uv), to_jax(valid), to_jax(prev), np.uint32(seed))
    idx = jax_pnp_indices(valid, seed, JCFG.pnp_iterations, JCFG.pnp_sample_size)
    got = tpnp.pnp_ransac_core(to_torch(p3), to_torch(uv), to_torch(valid),
                               port_camera(JCAM), to_torch(prev), to_torch(idx),
                               FrontendConfig())
    assert_equal(got.inliers, want.inliers, "inliers")
    assert_equal(got.num_inliers, want.num_inliers, "num_inliers")
    assert bool(got.ok) == bool(want.ok)
    assert_close(got.pose, want.pose, atol=POSE_TOL, what="pose")
    # and both found the true pose
    assert np.abs(np.asarray(want.pose)[4:] - pose_true[4:]).max() < 0.1


def test_dlt_hypotheses_match_reference(rng):
    """The minimal solver alone, batched over samples (DLT + polar iteration).
    Its 12x12 null vector is ill-conditioned by nature, so f32 rounding
    differences grow there: rotations within 1e-3, translations within 1e-2 m
    (the polish and LO rounds downstream remove them, see the test above)."""
    p3, uv, valid, _ = _problem(rng, outlier_frac=0.0, noise_px=0.3)
    idx = jax_pnp_indices(valid, 3, 32, 6)
    xn = (uv - [JCAM.cx, JCAM.cy]) / JCAM.focal
    want_r, want_t, want_ok = _jax_dlt(to_jax(p3[idx]), to_jax(xn[idx]))
    got_r, got_t, got_ok = tpnp._dlt_pose(to_torch(p3[idx]), to_torch(xn[idx].astype(np.float32)))
    assert_equal(got_ok, want_ok)
    assert_close(got_r, want_r, atol=1e-3, what="R")
    assert_close(got_t, want_t, atol=1e-2, rtol=1e-3, what="t")


@pytest.mark.parametrize("seed", [0, 1, 2**31, 2**32 - 1])
def test_prng_split_and_bits_match_jax(seed):
    """``prng.prng_key``, ``split`` and ``random_bits`` against ``jax.random``
    bitwise, at both ends of the uint32 seed range."""
    key = jax.random.PRNGKey(np.uint32(seed))
    tkey = prng.prng_key(seed)
    assert_equal(tkey, np.asarray(key).astype(np.int64), "key")
    keys = jax.random.split(key, 99)
    tkeys = prng.split(tkey, 99)
    assert_equal(tkeys, np.asarray(keys).astype(np.int64), "split")
    bits = jax.vmap(lambda k: jax.random.bits(k, (448,), jnp.uint32))(keys)
    assert_equal(prng.random_bits(tkeys, 448), np.asarray(bits).astype(np.int64), "bits")


def test_gumbel_matches_jax_on_every_uniform():
    """The draw's Gumbel values, ``-log(-log(u))``, take only 2^23 uniforms
    ``u``, one per mantissa: ``prng.gumbel_table`` equals XLA's own (``jnp``
    on the CPU) on all of them, and ``prng.log_f32`` equals ``jnp.log`` on
    each inner and outer argument and on every ``1 / n`` of ``log(p)``;
    ``torch.log`` does not (one ulp off on about one input in seven). And
    ``prng.gumbel`` equals ``jax.random.gumbel`` on seeded keys."""
    mant = np.arange(2**23, dtype=np.int32)
    u = (mant | np.int32(0x3F800000)).view(np.float32) - np.float32(1.0)
    u = np.maximum(u + prng.FLOAT32_TINY, prng.FLOAT32_TINY).astype(np.float32)
    assert_equal(prng.uniform(torch.from_numpy(mant.astype(np.int64))), u, "uniform")
    xla_log = jax.jit(jnp.log)
    inner = np.asarray(xla_log(u))
    assert_equal(prng.log_f32(torch.from_numpy(u)).view(torch.int32), inner.view(np.int32), "inner")
    assert not np.array_equal(torch.log(torch.from_numpy(u)).numpy(), inner)
    want = np.asarray(jax.jit(lambda x: -jnp.log(-jnp.log(x)))(u))
    assert_equal(prng.gumbel_table("cpu").view(torch.int32), want.view(np.int32), "table")
    n = np.arange(4097, dtype=np.float32)
    p = np.float32(1.0) / np.maximum(n, np.float32(1.0))          # p of the draw
    assert_equal(prng.log_inverse_counts(4096, "cpu").view(torch.int32),
                 np.asarray(xla_log(p)).view(np.int32), "log(1/n)")
    special = np.array([0.0, -0.0, 1e-40, np.inf, -1.0, np.nan, 1.0], np.float32)
    np.testing.assert_array_equal(prng.log_f32(torch.from_numpy(special)).numpy(),
                                  np.asarray(xla_log(special)))
    keys = jax.random.split(jax.random.PRNGKey(np.uint32(77)), 64)
    gum = jax.vmap(lambda k: jax.random.gumbel(k, (448,), jnp.float32))(keys)
    got = prng.gumbel(prng.split(prng.prng_key(77), 64), 448)
    assert_equal(got.view(torch.int32), np.asarray(gum).view(np.int32), "gumbel")


def test_fma_f32_rounds_once():
    """``prng.fma_f32`` equals the exactly rounded ``a * b + c``, also where
    the float64 sum lands halfway between two float32s (plain float64
    arithmetic rounds twice there and gets it wrong)."""
    from fractions import Fraction

    def nearest_f32(x):
        f = np.float32(float(x))
        cands = [np.nextafter(f, np.float32(-np.inf)), f, np.nextafter(f, np.float32(np.inf))]
        return min(cands, key=lambda y: (abs(Fraction(float(y)) - x),
                                         int(np.array(y).view(np.int32)) & 1))

    hi, lo = 2.0**-12 * (1 + 2.0**-16), 2.0**-12 * (1 - 2.0**-16)
    a = np.array([hi, -hi, hi, hi], np.float32)
    b = np.array([lo, lo, -lo, lo], np.float32)
    c = np.array([1 + 2.0**-23, -(1 + 2.0**-23), 1 + 2.0**-22, 1.0], np.float32)
    rng = np.random.default_rng(5)
    a = np.concatenate([a, rng.standard_normal(300).astype(np.float32)])
    b = np.concatenate([b, rng.standard_normal(300).astype(np.float32)])
    c = np.concatenate([c, (rng.standard_normal(300) * 10.0 ** rng.integers(-8, 2, 300))
                        .astype(np.float32)])
    got = prng.fma_f32(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c)).numpy()
    want = np.array([nearest_f32(Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z)))
                     for x, y, z in zip(a, b, c)], np.float32)
    assert_equal(got, want)
    naive = (a.astype(np.float64) * b + c).astype(np.float32)
    assert naive[0] != want[0]                       # the case that needs round-to-odd


N_SEEDS = 200


@pytest.mark.parametrize("f_cap", [448, 384])
@pytest.mark.parametrize("share", [0.0, 3 / 448, 0.1, 0.5, 1.0])
def test_sample_hypotheses_matches_jax_draw(share, f_cap):
    """``sample_hypotheses`` returns exactly the reference's minimal samples
    (``stereo_vo_tpu/frontend/pnp.py::pnp_ransac``: ``split`` then
    ``choice(replace=False, p=valid / n_valid)``) for ``N_SEEDS`` seeds and
    masks, at the main path's 99 x 6 draw. Share 3/448 leaves fewer valid
    slots than the sample size, share 0 none."""
    rng = np.random.default_rng(int(share * 1000) + f_cap)
    n_valid = int(round(share * f_cap))
    valids = np.zeros((N_SEEDS, f_cap), bool)
    for row in valids:
        row[rng.choice(f_cap, n_valid, replace=False)] = True
    seeds = np.concatenate([[0, 1, 2**31, 2**32 - 1],
                            rng.integers(0, 2**32, N_SEEDS - 4)]).astype(np.uint32)
    n_hyp, k = JCFG.pnp_iterations, JCFG.pnp_sample_size
    want = jax_pnp_indices_batch(valids, seeds, n_hyp, k)
    for i in range(N_SEEDS):
        got = tpnp.sample_hypotheses(torch.from_numpy(valids[i]), n_hyp - 1, k, int(seeds[i]))
        assert got.dtype == torch.int64
        assert_equal(got, want[i], f"seed {seeds[i]}")
    assert_equal(want[0], jax_pnp_indices(valids[0], int(seeds[0]), n_hyp, k), "helper")


def test_sample_hypotheses_reads_nothing_back():
    """The draw needs no value of the mask on the host: on the ``meta``
    device, where any read-back (``.item()``, ``int()``, ``.cpu()``) raises,
    it still returns its ``[n_draws, k]`` indices there."""
    valid = torch.ones(448, dtype=torch.bool, device="meta")
    idx = tpnp.sample_hypotheses(valid, 99, 6, seed=5)
    assert idx.device.type == "meta" and idx.shape == (99, 6) and idx.dtype == torch.int64
    with pytest.raises((RuntimeError, NotImplementedError)):
        int(valid.sum())


def test_seeded_sampling_draws_distinct_valid_slots():
    valid = torch.zeros(300, dtype=torch.bool)
    valid[::3] = True
    a = tpnp.sample_hypotheses(valid, 99, 6, seed=12)
    b = tpnp.sample_hypotheses(valid, 99, 6, seed=12)
    assert a.shape == (99, 6) and a.dtype == torch.int64
    assert torch.equal(a, b)
    assert bool(valid[a].all())
    assert all(len(set(row.tolist())) == 6 for row in a)
    few = torch.zeros(300, dtype=torch.bool)
    few[:3] = True                                   # fewer valid slots than k
    c = tpnp.sample_hypotheses(few, 5, 6, seed=0)
    assert all(len(set(row.tolist())) == 6 for row in c)
