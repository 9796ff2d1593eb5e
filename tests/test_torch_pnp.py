"""Parity of PnP-RANSAC with the JAX package, with the reference's minimal
samples injected.

The reference draws its hypotheses with ``jax.random``; the tests rebuild
those indices with the same calls (``torch_port_helpers.jax_pnp_indices``) and
hand them to ``pnp_ransac_core``. Tolerance: pose within 1e-4 (quaternion
and translation components, translations of a few metres) and identical
inlier masks. Both packages polish the winning hypothesis with the same GN
iterations; what differs is f32 rounding in the 12x12 null-vector solve and
the 6x6 LAPACK solves.
"""

import jax
import numpy as np
import pytest
import torch

from stereo_vo_tpu.core.camera import CameraInfo as JCameraInfo
from stereo_vo_tpu.core.config import FrontendConfig as JFrontendConfig
from stereo_vo_tpu.core.geometry import quat_to_rotmat
from stereo_vo_tpu.frontend import pnp as jpnp

from stereo_vo_tpu_torch.core.config import FrontendConfig
from stereo_vo_tpu_torch.frontend import pnp as tpnp

from torch_port_helpers import (
    assert_close,
    assert_equal,
    jax_pnp_indices,
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
