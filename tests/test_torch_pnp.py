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

The hypothesis stage (``pnp_hypotheses``) on six kinds of minimal sample:
its plain version against the JAX package's ``one_hypothesis``, the
kernel's source built for the host (``pnp_hypotheses_host``) against the
plain version, and, marked ``cuda``, the kernel on the card against both
(``python -m pytest tests/test_torch_pnp.py -m cuda --noconftest -q``; JAX
is imported inside the CPU tests only). ``eval.parity.hypothesis_hold``
holds each hypothesis: ok flags equal, and an ok pose within ``POSE_TOL``
plus ``SPREAD_FACTOR`` times its own rounding spread, read from one-ulp
nudged reruns of both sides; where that spread exceeds ``POSE_TOL`` rounding
decides the sample, which is counted and not compared.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from stereo_vo_tpu_torch.core.camera import CameraInfo
from stereo_vo_tpu_torch.core.config import FrontendConfig
from stereo_vo_tpu_torch.core.geometry import quat_to_rotmat as port_quat_to_rotmat
from stereo_vo_tpu_torch.eval.parity import hypothesis_hold
from stereo_vo_tpu_torch.frontend import pnp as tpnp
from stereo_vo_tpu_torch.frontend import prng

from torch_port_helpers import (
    assert_close,
    assert_equal,
    jax_pnp_indices,
    jax_pnp_indices_batch,
    to_jax,
    to_torch,
)

TCAM = CameraInfo(focal=718.856, cx=607.1928, cy=185.2157, baseline=0.537)
POSE_TOL = 1e-4
TCFG = FrontendConfig()


@functools.lru_cache(maxsize=None)
def _jax():
    """The JAX package's pieces these tests hold the port to, imported at
    first use: the ``cuda`` tests run on a machine without JAX."""
    import types

    import jax
    import jax.numpy as jnp

    from stereo_vo_tpu.core.camera import CameraInfo as JCameraInfo
    from stereo_vo_tpu.core.config import FrontendConfig as JFrontendConfig
    from stereo_vo_tpu.core.geometry import make_pose, quat_to_rotmat, rotmat_to_quat
    from stereo_vo_tpu.frontend import pnp as jpnp

    jcam = JCameraInfo(**dataclasses.asdict(TCAM))
    jcfg = JFrontendConfig()

    def one_hypothesis(p3, xn, uv, polish_iters):
        """``pnp_ransac``'s ``one_hypothesis`` less the draw."""
        r, t, ok = jpnp._dlt_pose(p3, xn)
        pose = make_pose(rotmat_to_quat(r), t.astype(p3.dtype))
        pose = jpnp._gn_refine(pose, p3, uv, jnp.ones(p3.shape[0], bool), jcam, polish_iters)
        return pose, ok & jnp.all(jnp.isfinite(pose))

    @functools.partial(jax.jit, static_argnums=3)
    def hypotheses(p3, uv, idx, polish_iters):
        xn = (uv - jnp.array([jcam.cx, jcam.cy], uv.dtype)) / jnp.asarray(jcam.focal, uv.dtype)
        return jax.vmap(lambda i: one_hypothesis(p3[i], xn[i], uv[i], polish_iters))(idx)

    return types.SimpleNamespace(
        jax=jax, jnp=jnp, jpnp=jpnp, quat_to_rotmat=quat_to_rotmat, JCFG=jcfg,
        pnp=jax.jit(lambda p3, uv, valid, prev, seed: jpnp.pnp_ransac(
            p3, uv, valid, jcam, prev, seed, jcfg)),
        dlt=jax.jit(jax.vmap(jpnp._dlt_pose)), hypotheses=hypotheses)


def _problem(rng, n=200, outlier_frac=0.2, noise_px=0.5):
    """World points seen by a camera at a random pose, with pixel noise,
    gross outliers and invalid slots."""
    yaw = rng.uniform(-0.2, 0.2)
    q = np.array([np.cos(yaw / 2), 0.0, np.sin(yaw / 2), 0.0])
    t = rng.normal(size=3) * [0.5, 0.1, 1.0]
    pose = np.concatenate([q, t]).astype(np.float32)
    p_cam = np.stack([rng.uniform(-12, 12, n), rng.uniform(-3, 3, n),
                      rng.uniform(5, 40, n)], 1)
    r = np.asarray(_jax().quat_to_rotmat(to_jax(q)))
    p_world = (p_cam - t) @ r                           # R^T (p_cam - t)
    uv = p_cam[:, :2] / p_cam[:, 2:3] * TCAM.focal + [TCAM.cx, TCAM.cy]
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
    want = _jax().pnp(to_jax(p3), to_jax(uv), to_jax(valid), to_jax(prev), np.uint32(seed))
    idx = jax_pnp_indices(valid, seed, TCFG.pnp_iterations, TCFG.pnp_sample_size)
    got = tpnp.pnp_ransac_core(to_torch(p3), to_torch(uv), to_torch(valid),
                               TCAM, to_torch(prev), to_torch(idx),
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
    xn = (uv - [TCAM.cx, TCAM.cy]) / TCAM.focal
    want_r, want_t, want_ok = _jax().dlt(to_jax(p3[idx]), to_jax(xn[idx]))
    got_r, got_t, got_ok = tpnp._dlt_pose(to_torch(p3[idx]), to_torch(xn[idx].astype(np.float32)))
    assert_equal(got_ok, want_ok)
    assert_close(got_r, want_r, atol=1e-3, what="R")
    assert_close(got_t, want_t, atol=1e-2, rtol=1e-3, what="t")


@pytest.mark.parametrize("seed", [0, 1, 2**31, 2**32 - 1])
def test_prng_split_and_bits_match_jax(seed):
    """``prng.prng_key``, ``split`` and ``random_bits`` against ``jax.random``
    bitwise, at both ends of the uint32 seed range."""
    jax, jnp = _jax().jax, _jax().jnp
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
    jax, jnp = _jax().jax, _jax().jnp
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
    n_hyp, k = TCFG.pnp_iterations, TCFG.pnp_sample_size
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


# the hypothesis stage (``pnp_hypotheses``): its plain version against the
# JAX package's one_hypothesis, and the kernel's arithmetic against the plain
# version. Rounding decides ill-conditioned samples; ``hypothesis_hold``
# measures that with one-ulp nudged reruns of both sides and compares the
# rest within POSE_TOL plus SPREAD_FACTOR times their own rounding spread
# (one nudge samples it once; two independent roundings part by a few such
# samples).
SPREAD_FACTOR = 4.0
F_CAP = 448
N_SAMPLES = 99
SAMPLE_KINDS = ("drawn", "inliers", "repeated", "coplanar", "few_valid", "not_ok")


def _scene(rng, outlier_frac=0.2, noise_px=0.5, plane=False):
    """``F_CAP`` world points seen by a camera at a random pose, as
    ``_problem`` makes them (without JAX), or on one plane in front of it:
    ``(p3, uv, valid, outlier)`` in float32 / bool numpy."""
    yaw = rng.uniform(-0.2, 0.2)
    q = np.array([np.cos(yaw / 2), 0.0, np.sin(yaw / 2), 0.0], np.float32)
    t = rng.normal(size=3) * [0.5, 0.1, 1.0]
    x, y = rng.uniform(-12, 12, F_CAP), rng.uniform(-3, 3, F_CAP)
    z = 20.0 + 0.3 * x - 0.5 * y if plane else rng.uniform(5, 40, F_CAP)
    p_cam = np.stack([x, y, z], 1)
    r = port_quat_to_rotmat(torch.from_numpy(q)).double().numpy()
    p_world = (p_cam - t) @ r
    uv = p_cam[:, :2] / p_cam[:, 2:3] * TCAM.focal + [TCAM.cx, TCAM.cy]
    uv += rng.normal(size=uv.shape) * noise_px
    outlier = rng.random(F_CAP) < outlier_frac
    uv[outlier] += rng.uniform(-80, 80, size=(outlier.sum(), 2))
    valid = rng.random(F_CAP) < 0.9
    return p_world.astype(np.float32), uv.astype(np.float32), valid, outlier


def _samples(kind, seed):
    """``(p3, uv, hyp_idx)`` torch tensors on the CPU: ``N_SAMPLES`` minimal
    samples of one kind. ``drawn``: the draw of a frame (``sample_hypotheses``,
    bitwise the reference's) on a scene with 20% outliers; ``inliers``: six
    distinct valid inliers each; ``repeated``: one point taken twice;
    ``coplanar``: six points of one plane; ``few_valid``: the draw on a mask
    with 3 valid slots, which fills the sample with the lowest invalid slots
    (zeros, as a frame's unused slots); ``not_ok``: one point six times."""
    rng = np.random.default_rng(seed)
    p3, uv, valid, outlier = _scene(rng, plane=kind == "coplanar",
                                    outlier_frac=0.0 if kind == "inliers" else 0.2)
    pick = np.nonzero(valid & ~outlier)[0]
    if kind in ("drawn", "few_valid"):
        if kind == "few_valid":
            valid = np.zeros(F_CAP, bool)
            valid[rng.choice(F_CAP, 3, replace=False)] = True
            p3[~valid], uv[~valid] = 0.0, 0.0
        idx = tpnp.sample_hypotheses(torch.from_numpy(valid), N_SAMPLES, 6, seed).numpy()
    elif kind == "not_ok":
        idx = np.repeat(rng.choice(pick, (N_SAMPLES, 1)), 6, axis=1)
    else:
        idx = np.stack([rng.choice(pick, 6, replace=False) for _ in range(N_SAMPLES)])
        if kind == "repeated":
            idx[:, 1] = idx[:, 0]
    return torch.from_numpy(p3), torch.from_numpy(uv), torch.from_numpy(idx.astype(np.int64))


def _same_bits(a, b) -> bool:
    """Equal bits, or NaN in both (whatever its sign and payload)."""
    return bool(((a.view(torch.int32) == b.view(torch.int32))
                 | (torch.isnan(a) & torch.isnan(b))).all())


def _nudged(*xs):
    return tuple(torch.nextafter(x, torch.full_like(x, float("inf"))) for x in xs)


def _hold(kind, got, want, got_nudged, want_nudged):
    """``hypothesis_hold`` of two sides, with what each kind must show."""
    report = hypothesis_hold(got, want, got_nudged, want_nudged, POSE_TOL, SPREAD_FACTOR)
    assert report["failed"] == [], (kind, report)
    ok = np.asarray(want[1])
    if kind == "inliers":
        assert report["rounding_decided"] <= N_SAMPLES // 10 and ok.all(), (kind, report)
    elif kind == "drawn":
        assert report["rounding_decided"] <= 0.6 * N_SAMPLES and ok.all(), (kind, report)
    elif kind in ("not_ok", "few_valid"):
        assert not ok.any() and not np.asarray(got[1]).any(), (kind, report)
    return report


@pytest.mark.parametrize("kind", SAMPLE_KINDS)
def test_pnp_hypotheses_ref_matches_reference(kind):
    """``pnp_hypotheses_ref`` (the plain version, moved unchanged out of
    ``pnp_ransac_core``) against the JAX package's ``one_hypothesis`` less the
    draw, vmapped over the same samples, polish included."""
    p3, uv, idx = _samples(kind, SAMPLE_KINDS.index(kind) + 11)
    polish = TCFG.pnp_hyp_polish_iters

    def run_ref(a, b):
        return tuple(t.numpy() for t in tpnp.pnp_hypotheses_ref(a, b, idx, TCAM, polish))

    def run_jax(a, b):
        pose, ok = _jax().hypotheses(to_jax(a), to_jax(b), to_jax(idx.numpy()), polish)
        return np.asarray(pose), np.asarray(ok)

    nudged = _nudged(p3, uv)
    _hold(kind, run_ref(p3, uv), run_jax(p3, uv), run_ref(*nudged), run_jax(*nudged))


@pytest.mark.parametrize("kind", SAMPLE_KINDS)
def test_pnp_hypotheses_kernel_arithmetic_matches_ref(kind):
    """The kernel's source built for the host (``pnp_hypotheses_host``)
    against the plain version: bitwise before the polish (the DLT, its
    null vector, the polar fix and the quaternion round as torch's CPU ops
    round them), and through the polish by ``hypothesis_hold`` (its 6x6 LU
    solve sums in LAPACK's blocked order there, and sin and cos are libm's)."""
    p3, uv, idx = _samples(kind, SAMPLE_KINDS.index(kind) + 11)
    want = tpnp.pnp_hypotheses_ref(p3, uv, idx, TCAM, 0)
    got = tpnp.pnp_hypotheses_host(p3, uv, idx, TCAM, 0)
    assert _same_bits(got[0], want[0]), f"{kind}: pose bits"
    assert_equal(got[1], want[1], f"{kind}: ok")
    polish = TCFG.pnp_hyp_polish_iters
    nudged = _nudged(p3, uv)
    runs = [tuple(t.numpy() for t in fn(a, b, idx, TCAM, polish))
            for a, b in ((p3, uv), nudged)
            for fn in (tpnp.pnp_hypotheses_host, tpnp.pnp_hypotheses_ref)]
    _hold(kind, runs[0], runs[1], runs[2], runs[3])


def test_pnp_hypotheses_refuses_what_it_cannot_take():
    """Six points a sample, float32 points and pixels, int64 indices, one
    device: anything else raises on the CPU as on the card."""
    p3, uv, idx = _samples("inliers", 3)
    for bad in (dict(hyp_idx=idx[:, :5]), dict(hyp_idx=torch.cat([idx, idx[:, :1]], 1)),
                dict(hyp_idx=idx.to(torch.int32)), dict(p3=p3.double()),
                dict(uv=uv.to(torch.float16)), dict(uv=uv[:-1]), dict(p3=p3[:, :2])):
        args = dict(p3=p3, uv=uv, hyp_idx=idx, cam=TCAM, polish_iters=2)
        args.update(bad)
        with pytest.raises(ValueError, match="pnp_hypotheses"):
            tpnp.pnp_hypotheses(**args)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", SAMPLE_KINDS)
def test_cuda_pnp_hypotheses_match_plain(kind):
    """The kernel (``csrc/pnp_hyp.cu``) on the card: bitwise its own
    arithmetic built for the host before the polish (NaN as NaN), and
    through the polish held by ``hypothesis_hold`` to the plain version on
    the CPU and to the host build (the card's sin and cos round otherwise
    than libm's and torch's, and the plain version's LU sums in LAPACK's
    blocked order)."""
    dev = _card()
    p3, uv, idx = _samples(kind, SAMPLE_KINDS.index(kind) + 11)

    def card(a, b, polish):
        out = tpnp.pnp_hypotheses(a.to(dev), b.to(dev), idx.to(dev), TCAM, polish)
        return tuple(t.cpu() for t in out)

    pre, host = card(p3, uv, 0), tpnp.pnp_hypotheses_host(p3, uv, idx, TCAM, 0)
    assert _same_bits(pre[0], host[0]), f"{kind}: pose bits before the polish"
    assert_equal(pre[1], host[1], f"{kind}: ok before the polish")
    polish = TCFG.pnp_hyp_polish_iters
    nudged = _nudged(p3, uv)
    for plain in (tpnp.pnp_hypotheses_ref, tpnp.pnp_hypotheses_host):
        runs = [tuple(t.numpy() for t in fn(a, b, polish))
                for a, b in ((p3, uv), nudged)
                for fn in (card, lambda a, b, k: plain(a, b, idx, TCAM, k))]
        _hold(kind, runs[0], runs[1], runs[2], runs[3])


@pytest.mark.cuda
def test_cuda_pnp_ransac_launches_once_replays_bitwise_reads_nothing():
    """``pnp_ransac`` on the card: one kernel launch a call, eager and in a
    replayed CUDA graph (counted on the device), the replay bitwise the
    eager call, no host read (``test_torch_sync_free.HostReads``); and the
    wrapper refuses a sample size other than 6, other dtypes and
    non-contiguous inputs. The graph holds the call in a ``cond`` body, as
    the step graph does: every program captures its bodies on one stream,
    where cuSOLVER's scratch for the PnP's 6x6 solves is taken once
    (``engine/graphs.py::_body_stream``)."""
    from stereo_vo_tpu_torch.core.consts import const
    from stereo_vo_tpu_torch.engine.graphs import Program, cond
    from test_torch_sync_free import HostReads

    dev = _card()
    p3, uv, valid, _ = _scene(np.random.default_rng(23))
    prev = torch.tensor([1, 0, 0, 0, 0.2, -0.05, 0.4], device=dev)
    args = (torch.from_numpy(p3).to(dev), torch.from_numpy(uv).to(dev),
            torch.from_numpy(valid).to(dev), prev, torch.tensor(17, device=dev))

    def call(inputs):
        return tpnp.pnp_ransac(inputs[0], inputs[1], inputs[2], TCAM, inputs[3], inputs[4], TCFG)

    call(args)
    before = tpnp.pnp_hypotheses.launches
    with HostReads() as counter:
        eager = call(args)
    assert counter.reads == []
    assert tpnp.pnp_hypotheses.launches == before + 1
    def skip(inputs):
        return tpnp.PnPResult(pose=inputs[3], inliers=torch.zeros_like(inputs[2]),
                              num_inliers=const(0, torch.int64, dev),
                              ok=const(False, torch.bool, dev))

    run = const(True, torch.bool, dev)
    program = Program("pnp", lambda carry, inputs: ((), cond(run, call, skip, (inputs,))))
    program((), args)
    program.flush_launches()
    before = tpnp.pnp_hypotheses.launches
    _, replayed = program((), args)
    program.flush_launches()
    assert program.replays == 1 and tpnp.pnp_hypotheses.launches == before + 1
    for name, got, want in zip(tpnp.PnPResult._fields, replayed, eager):
        got, want = got.reshape(-1).view(torch.uint8), want.reshape(-1).view(torch.uint8)
        assert torch.equal(got, want), name
    assert bool(eager.ok) and int(eager.num_inliers) > 0.5 * valid.sum()

    idx = tpnp.sample_hypotheses(args[2], 99, 6, 17)
    for bad, match in ((dict(hyp_idx=idx[:, :5].contiguous()), "hyp_idx"),
                       (dict(p3=args[0].double()), "p3"),
                       (dict(hyp_idx=idx.to(torch.int32)), "hyp_idx"),
                       (dict(p3=args[0].t().contiguous().t()), "contiguous"),
                       (dict(hyp_idx=torch.cat([idx, idx], 1)[:, ::2]), "contiguous")):
        kw = dict(p3=args[0], uv=args[1], hyp_idx=idx, cam=TCAM, polish_iters=2)
        kw.update(bad)
        with pytest.raises(ValueError, match=match):
            tpnp.pnp_hypotheses(**kw)
