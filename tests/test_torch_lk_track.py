"""Parity of pyramidal LK (``lk_track_fwdbwd``) and the tracker step with the
JAX package, on synthetic frames and on the photographic fixtures.

Tolerance: tracked and round-trip positions within 1e-3 px, status flags
identical. The port samples bilinearly by direct indexing where the
reference multiplies by selector matrices, and reduces the 21x21 GN sums in
another order, so the two differ by f32 rounding inside each iteration; the
iterations contract, so the difference stays far below the bound.
"""

import functools
import os

import jax
import numpy as np
import pytest

from stereo_vo_tpu.core.camera import CameraInfo as JCameraInfo
from stereo_vo_tpu.core.config import FrontendConfig as JFrontendConfig
from stereo_vo_tpu.data.synthetic import SyntheticStereoSequence
from stereo_vo_tpu.frontend.track import track_step as jax_track_step
from stereo_vo_tpu.frontend.track import tracker_init as jax_tracker_init
from stereo_vo_tpu.ops.lk import lk_track_fwdbwd as jax_lk
from stereo_vo_tpu.ops.pyramid import build_pyramid as jax_build_pyramid
from stereo_vo_tpu.ops.shi_tomasi import detect_corners as jax_detect

from stereo_vo_tpu_torch.core.config import FrontendConfig
from stereo_vo_tpu_torch.frontend.track import track_step, tracker_init
from stereo_vo_tpu_torch.ops.lk import lk_track_fwdbwd
from stereo_vo_tpu_torch.ops.pyramid import build_pyramid

from torch_port_helpers import assert_close, assert_equal, to_jax, to_torch

POS_TOL = 1e-3
FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures", "real")
JCAM = JCameraInfo(focal=300.0, cx=160.0, cy=120.0, baseline=0.3)


@pytest.fixture(scope="module")
def world_frames():
    world = SyntheticStereoSequence(cam=JCAM, n_frames=3, shape=(240, 320),
                                    n_points=900, seed=5, speed=0.5, yaw_rate=0.01)
    return [world.render(i)[0].astype(np.float32) for i in range(3)]


def _fixture_frames():
    from PIL import Image

    # a 240x320 crop of the KITTI-sized photographic fixtures keeps the
    # test small while keeping natural image statistics
    return [np.asarray(Image.open(os.path.join(FIXDIR, "image_0", f"{i:06d}.png")),
                       np.float32)[70:310, 450:770] for i in (0, 1)]


def _points(img, n):
    xy, _, valid = jax_detect(to_jax(img), max_corners=n, min_distance=8.0)
    xy, valid = np.array(xy), np.array(valid)
    # invalid slots keep arbitrary positions, as the tracker's do
    xy[~valid] = np.array([5.0, 7.0], np.float32)
    return xy, valid


@functools.lru_cache(maxsize=None)
def _jax_lk(levels, **kw):
    kw = dict(kw)

    def run(prev_pyr, next_pyr, pts, valid, init_flow):
        return jax_lk(prev_pyr, next_pyr, pts, valid, init_flow=init_flow, **kw)

    return jax.jit(run)


def _compare_lk(prev, nxt, pts, valid, levels=4, init_flow=None, **kw):
    jp = jax_build_pyramid(to_jax(prev), 3)[:levels]
    jn = jax_build_pyramid(to_jax(nxt), 3)[:levels]
    want = _jax_lk(levels, **kw)(list(jp), list(jn), to_jax(pts), to_jax(valid),
                                 None if init_flow is None else to_jax(init_flow))
    tp = build_pyramid(to_torch(prev), 3)[:levels]
    tn = build_pyramid(to_torch(nxt), 3)[:levels]
    got = lk_track_fwdbwd(tp, tn, to_torch(pts), to_torch(valid),
                          init_flow=None if init_flow is None else to_torch(init_flow), **kw)
    tracked, fwd_ok, back, bwd_ok = got
    assert_equal(fwd_ok, want[1], "fwd_ok")
    assert_equal(bwd_ok, want[3], "bwd_ok")
    ok = np.asarray(want[1])
    assert_close(tracked.numpy()[ok], np.asarray(want[0])[ok], atol=POS_TOL, what="tracked")
    bok = np.asarray(want[3])
    assert_close(back.numpy()[bok], np.asarray(want[2])[bok], atol=POS_TOL, what="back")
    assert ok.sum() > 0.5 * valid.sum()
    return got


@pytest.mark.parametrize("bwd_levels", [0, 2])
def test_lk_fwdbwd_synthetic(world_frames, bwd_levels):
    pts, valid = _points(world_frames[0], 160)
    _compare_lk(world_frames[0], world_frames[1], pts, valid, bwd_levels=bwd_levels)


def test_lk_hinted_short_pyramid(world_frames, rng):
    pts, valid = _points(world_frames[1], 128)
    flow = (rng.normal(size=pts.shape) * 2).astype(np.float32)
    _compare_lk(world_frames[1], world_frames[2], pts, valid, levels=2, init_flow=flow,
                bwd_levels=2, bwd_from_original=True)


@pytest.mark.skipif(not os.path.isdir(os.path.join(FIXDIR, "image_0")),
                    reason="real fixtures not generated")
def test_lk_fwdbwd_on_photographic_fixtures():
    prev, nxt = _fixture_frames()
    pts, valid = _points(prev, 128)
    _compare_lk(prev, nxt, pts, valid, bwd_levels=2)


def _tracker_pair(pyr_np, xy, ids, valid, flow=None, flow_valid=None, pred_err=None):
    import jax.numpy as jnp
    import torch

    jst = jax_tracker_init(tuple(to_jax(p) for p in pyr_np), to_jax(xy), to_jax(ids),
                           to_jax(valid),
                           None if flow is None else to_jax(flow),
                           None if flow_valid is None else to_jax(flow_valid),
                           None if pred_err is None else jnp.float32(pred_err))
    tst = tracker_init(tuple(to_torch(p) for p in pyr_np), to_torch(xy), to_torch(ids),
                       to_torch(valid),
                       None if flow is None else to_torch(flow),
                       None if flow_valid is None else to_torch(flow_valid),
                       None if pred_err is None else torch.tensor(pred_err, dtype=torch.float32))
    return jst, tst


def test_track_step(world_frames, rng):
    """Tracker step at 384 slots, compacted to 160, on the flow-hinted short
    pyramid (the full-pyramid step is held against the reference by the
    engine's step-parity test)."""
    f_cap = 384
    pts, valid = _points(world_frames[0], 140)
    xy = np.zeros((f_cap, 2), np.float32)
    xy[:140] = pts
    live = np.zeros(f_cap, bool)
    live[:140] = valid
    perm = rng.permutation(f_cap)              # scatter live slots across capacity
    xy, live = xy[perm], live[perm]
    ids = np.arange(f_cap, dtype=np.int32)
    pyr0 = [np.asarray(p) for p in jax_build_pyramid(to_jax(world_frames[0]), 3)]
    pyr1 = [np.asarray(p) for p in jax_build_pyramid(to_jax(world_frames[1]), 3)]
    flow = (rng.normal(size=xy.shape) + [4.0, 0.5]).astype(np.float32)
    kw = dict(flow=flow, flow_valid=live & (rng.random(f_cap) < 0.7), pred_err=2.0)
    jcfg = JFrontendConfig(lk_compact_slots=160)
    tcfg = FrontendConfig(lk_compact_slots=160)
    jst, tst = _tracker_pair(pyr0, xy, ids, live, **kw)
    jnew, jstats = jax.jit(lambda s, p: jax_track_step(s, p, jcfg))(
        jst, tuple(to_jax(p) for p in pyr1))
    tnew, tstats = track_step(tst, tuple(to_torch(p) for p in pyr1), tcfg)

    assert bool(tstats.hinted) and bool(jstats.hinted)
    assert_equal(tnew.feat_valid, jnew.feat_valid, "feat_valid")
    assert_equal(tnew.flow_valid, jnew.flow_valid, "flow_valid")
    assert_equal(tstats.num_tracked, jstats.num_tracked, "num_tracked")
    ok = np.asarray(jnew.feat_valid)
    assert live.sum() > 100 and ok.sum() > 0.5 * live.sum()
    assert_close(tnew.feat_xy, jnew.feat_xy, atol=POS_TOL, what="feat_xy")
    assert_close(tnew.flow_xy, jnew.flow_xy, atol=POS_TOL, what="flow_xy")
    assert_close(tstats.av_parallax, jstats.av_parallax, atol=POS_TOL, what="av_parallax")
    assert_close(tstats.percent_lost, jstats.percent_lost, atol=1e-6, what="percent_lost")
    assert_close(tnew.pred_err, jnew.pred_err, atol=POS_TOL, what="pred_err")
