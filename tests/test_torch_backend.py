"""Parity of the backend (residuals, window state, Schur-LM bundle adjustment)
with the JAX package.

Tolerances:
- residuals and Jacobians: f32 rounding of the same closed forms (rtol 1e-5,
  atol 1e-3 on pixel-scale values);
- ``add_keyframe``: integers and masks exact, floats to f32 rounding;
- ``bundle_adjust`` from one window: poses within 1e-4 and landmarks within
  1e-3 m (rtol 1e-4) after the whole LM loop, costs within rtol 1e-4, the
  same number of accepted steps. The two packages sum the normal equations
  in different orders, so each LM step differs by f32 rounding.
"""

import jax
import numpy as np
import pytest

from stereo_vo_tpu.backend import residuals as jres
from stereo_vo_tpu.backend import schur as jschur
from stereo_vo_tpu.backend import window as jwin
from stereo_vo_tpu.core.camera import CameraInfo as JCameraInfo
from stereo_vo_tpu.core.config import BackendConfig as JBackendConfig

from stereo_vo_tpu_torch.backend import residuals as tres
from stereo_vo_tpu_torch.backend import schur as tschur
from stereo_vo_tpu_torch.backend import window as twin
from stereo_vo_tpu_torch.core.config import BackendConfig

from torch_port_helpers import assert_close, assert_equal, port_camera, to_jax, to_torch, to_numpy

JCAM = JCameraInfo(focal=400.0, cx=160.0, cy=120.0, baseline=0.5)
TCAM = port_camera(JCAM)
CFG_KW = dict(window_size=4, feature_capacity=96, landmark_capacity=256, max_features=80)


def _poses(rng, n, scale=1.0):
    q = rng.normal(size=(n, 4)) * [0.05, 0.05, 0.05, 0.05] + [1, 0, 0, 0]
    q *= scale                                        # non-unit quaternions too
    t = rng.normal(size=(n, 3)) * [0.3, 0.1, 0.5]
    return np.concatenate([q, t], 1).astype(np.float32)


def test_residuals_and_jacobians(rng):
    n = 256
    pose = _poses(rng, n, scale=1.3)
    pts = np.stack([rng.uniform(-5, 5, n), rng.uniform(-2, 2, n),
                    rng.uniform(4, 30, n)], 1).astype(np.float32)
    obs = rng.uniform(0, 320, size=(n, 2)).astype(np.float32)
    want = jres.reprojection_jacobians(*to_jax((pose, pts, obs)), JCAM)
    got = tres.reprojection_jacobians(*to_torch((pose, pts, obs)), TCAM)
    for name, g, w in zip(("r", "J_pose", "J_point"), got, want):
        assert_close(g, w, atol=1e-3, rtol=1e-5, what=name)
    assert_close(tres.reprojection_residual(*to_torch((pose, pts, obs)), TCAM),
                 jres.reprojection_residual(*to_jax((pose, pts, obs)), JCAM),
                 atol=1e-3, rtol=1e-5, what="residual")


def _keyframe_inputs(rng, f, n_lm_live, lcap, pose_shift):
    """Tracked observations of live landmarks + new features for one keyframe."""
    tracked_lm = rng.choice(n_lm_live, size=f, replace=True).astype(np.int32)
    tracked_lm[: min(f, n_lm_live)] = rng.permutation(n_lm_live)[:f]
    tracked_valid = rng.random(f) < 0.5
    # each landmark observed at most once per keyframe
    _, first = np.unique(tracked_lm, return_index=True)
    uniq = np.zeros(f, bool)
    uniq[first] = True
    tracked_valid &= uniq
    pose = np.array([1, 0, 0, 0, 0.1 * pose_shift, 0, 0.4 * pose_shift], np.float32)
    return dict(
        pose=pose,
        tracked_uv=rng.uniform(0, 320, (f, 2)).astype(np.float32),
        tracked_lm=tracked_lm,
        tracked_valid=tracked_valid,
        new_uv=rng.uniform(0, 320, (f, 2)).astype(np.float32),
        new_p3=(rng.normal(size=(f, 3)) * [3, 1, 4] + [0, 0, 15]).astype(np.float32),
        new_valid=rng.random(f) < 0.7,
        new_prior_w=rng.uniform(0.1, 5, f).astype(np.float32),
        tracked_prior_pos=(rng.normal(size=(f, 3)) + [0, 0, 15]).astype(np.float32),
        tracked_prior_w=np.where(rng.random(f) < 0.6, rng.uniform(0.1, 3, f), 0).astype(np.float32),
    )


def test_add_keyframe_with_eviction_and_recycling(rng):
    jcfg, tcfg = JBackendConfig(**CFG_KW), BackendConfig(**CFG_KW)
    jst, tst = jwin.empty_window(jcfg), twin.empty_window(tcfg)
    f = CFG_KW["feature_capacity"]
    for k in range(7):                                # overflows the 4-slot window
        live = int(np.sum(np.asarray(jst.lm_valid)))
        inp = _keyframe_inputs(rng, f, max(live, 1), CFG_KW["landmark_capacity"], k)
        if live == 0:
            inp["tracked_valid"][:] = False
        jout = jwin.add_keyframe(jst, jcfg, **{k_: to_jax(v) for k_, v in inp.items()})
        tout = twin.add_keyframe(tst, tcfg, **{k_: to_torch(v) for k_, v in inp.items()})
        for name, g, w in zip(jwin.WindowState._fields, tout[0], jout[0]):
            g, w = to_numpy(g), to_numpy(w)
            if np.issubdtype(w.dtype, np.floating):
                assert_close(g, w, atol=1e-5, rtol=1e-6, what=f"kf {k} {name}")
            else:
                assert_equal(g, w, what=f"kf {k} {name}")
        assert_equal(tout[1], jout[1], f"kf {k} new_ids")
        assert_equal(tout[2], jout[2], f"kf {k} new_valid")
        jst, tst = jout[0], tout[0]
    assert_equal(twin.newest_pose(tst), jwin.newest_pose(jst))
    ids = np.arange(0, 40, dtype=np.int32)
    assert_equal(twin.get_world_points(tst, to_torch(ids)), jwin.get_world_points(jst, to_jax(ids)))


def _ba_window(rng, jcfg, n_lm=150, noise=0.8):
    """A window of 4 keyframes observing ``n_lm`` landmarks, with pixel noise,
    perturbed landmarks and poses, stereo priors and a carried damping."""
    w, f, lcap = jcfg.window_size, jcfg.feature_capacity, jcfg.landmark_capacity
    pts = np.stack([rng.uniform(-6, 6, n_lm), rng.uniform(-2, 2, n_lm),
                    rng.uniform(6, 25, n_lm)], 1)
    poses = np.zeros((w, 7), np.float32)
    poses[:, 0] = 1
    poses[:, 6] = -0.5 * np.arange(w)                 # forward motion (T_cw)
    obs_uv = np.zeros((w, f, 2), np.float32)
    obs_lm = np.zeros((w, f), np.int32)
    obs_valid = np.zeros((w, f), bool)
    lm_slots = rng.permutation(lcap)[:n_lm].astype(np.int32)   # scattered ids
    for k in range(w):
        seen = rng.permutation(n_lm)[:f]
        seen = seen[rng.random(len(seen)) < 0.85]
        pc = pts[seen] + poses[k, 4:]
        uv = pc[:, :2] / pc[:, 2:3] * JCAM.focal + [JCAM.cx, JCAM.cy]
        obs_uv[k, : len(seen)] = uv + rng.normal(size=uv.shape) * noise
        obs_lm[k, : len(seen)] = lm_slots[seen]
        obs_valid[k, : len(seen)] = True
    lm_pos = np.zeros((lcap, 3), np.float32)
    lm_valid = np.zeros(lcap, bool)
    lm_pos[lm_slots] = pts + rng.normal(size=pts.shape) * 0.2
    lm_valid[lm_slots] = True
    lm_prior = lm_pos + rng.normal(size=lm_pos.shape).astype(np.float32) * 0.05
    lm_prior_w = np.where(lm_valid, rng.uniform(0.5, 5, lcap), 0).astype(np.float32)
    poses[1:, 4:] += rng.normal(size=(w - 1, 3)) * 0.05
    return jwin.WindowState(
        poses=poses, pose_valid=np.ones(w, bool), obs_uv=obs_uv, obs_lm=obs_lm,
        obs_valid=obs_valid, lm_pos=lm_pos, lm_refcount=lm_valid.astype(np.int32),
        lm_valid=lm_valid, lm_prior=lm_prior, lm_prior_w=lm_prior_w,
        num_kf=np.int32(w), ba_lam=np.float32(3e-3),
    )


@pytest.mark.parametrize("compact", [192, 0])
def test_bundle_adjust_matches_reference(rng, compact):
    kw = dict(CFG_KW, ba_compact_landmarks=compact, max_lm_iters=10)
    jcfg, tcfg = JBackendConfig(**kw), BackendConfig(**kw)
    win = _ba_window(rng, jcfg)
    jwin_state = jwin.WindowState(*[to_jax(x) for x in win])
    twin_state = twin.WindowState(*[to_torch(x) for x in win])
    jout, jstats = jax.jit(lambda w: jschur.bundle_adjust(w, JCAM, jcfg))(jwin_state)
    tout, tstats = tschur.bundle_adjust(twin_state, TCAM, tcfg)

    assert int(tstats.iterations) == int(jstats.iterations) > 0
    assert_close(tstats.initial_cost, jstats.initial_cost, atol=0, rtol=1e-5, what="cost0")
    assert_close(tstats.final_cost, jstats.final_cost, atol=0, rtol=1e-4, what="cost")
    assert float(tstats.final_cost) < 0.5 * float(tstats.initial_cost)
    assert_close(tout.poses, jout.poses, atol=1e-4, what="poses")
    lv = np.asarray(win.lm_valid)
    assert_close(to_numpy(tout.lm_pos)[lv], np.asarray(jout.lm_pos)[lv], atol=1e-3, rtol=1e-4,
                 what="landmarks")
    assert_equal(to_numpy(tout.lm_pos)[~lv], np.asarray(jout.lm_pos)[~lv], "dead landmarks")
    assert_close(tout.ba_lam, jout.ba_lam, atol=0, rtol=1e-3, what="ba_lam")
