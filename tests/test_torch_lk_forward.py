"""Parity of forward-only pyramidal LK (``lk_track_pyramid``), the
forward-only tracker step (``track_step(flow_back=False)``) and maxpool
corner detection with the JAX package.

Tolerances: tracked positions within ``POS_TOL`` = 1e-3 px and status flags
identical, as for the fused forward-backward LK (``test_torch_lk_track.py``:
the port samples by direct indexing where the reference multiplies by
selector matrices, so each GN iteration differs by f32 rounding); maxpool
corner sets identical (same responses up to rounding, the same tie rules,
and a stable (value desc, index asc) top-k).
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
from stereo_vo_tpu.ops.lk import lk_track_pyramid as jax_lk_pyramid
from stereo_vo_tpu.ops.pyramid import build_pyramid as jax_build_pyramid
from stereo_vo_tpu.ops.shi_tomasi import detect_corners as jax_detect

from stereo_vo_tpu_torch.core.config import FrontendConfig
from stereo_vo_tpu_torch.frontend.track import NO_FLOW, track_step, tracker_init
from stereo_vo_tpu_torch.ops.lk import lk_track_pyramid
from stereo_vo_tpu_torch.ops.pyramid import build_pyramid
from stereo_vo_tpu_torch.ops.shi_tomasi import detect_corners

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

    return [np.asarray(Image.open(os.path.join(FIXDIR, "image_0", f"{i:06d}.png")),
                       np.float32)[70:310, 450:770] for i in (0, 1)]


def _points(img, n):
    xy, _, valid = jax_detect(to_jax(img), max_corners=n, min_distance=8.0)
    xy, valid = np.array(xy), np.array(valid)
    xy[~valid] = np.array([5.0, 7.0], np.float32)
    return xy, valid


@functools.lru_cache(maxsize=None)
def _jax_lk_pyramid():
    return jax.jit(lambda p, n, pts, valid: jax_lk_pyramid(p, n, pts, valid))


@pytest.mark.parametrize("source", ["synthetic", "photographic"])
def test_lk_track_pyramid_matches_reference(world_frames, source):
    if source == "photographic" and not os.path.isdir(os.path.join(FIXDIR, "image_0")):
        pytest.skip("real fixtures not generated")
    prev, nxt = world_frames[:2] if source == "synthetic" else _fixture_frames()
    pts, valid = _points(prev, 128)
    jp = list(jax_build_pyramid(to_jax(prev), 3))
    jn = list(jax_build_pyramid(to_jax(nxt), 3))
    want_xy, want_ok = _jax_lk_pyramid()(jp, jn, to_jax(pts), to_jax(valid))
    got_xy, got_ok = lk_track_pyramid(build_pyramid(to_torch(prev), 3),
                                      build_pyramid(to_torch(nxt), 3),
                                      to_torch(pts), to_torch(valid))
    assert_equal(got_ok, want_ok, "status")
    ok = np.asarray(want_ok)
    assert ok.sum() > 0.5 * valid.sum()
    assert_close(got_xy.numpy()[ok], np.asarray(want_xy)[ok], atol=POS_TOL, what="tracked")


def test_track_step_forward_only(world_frames, rng):
    """Forward-only tracker step at 448 slots with scattered live slots and a
    carried flow estimate (which the forward-only branch ignores)."""
    import jax.numpy as jnp
    import torch

    f_cap = 448
    pts, valid = _points(world_frames[0], 140)
    xy = np.zeros((f_cap, 2), np.float32)
    xy[:140] = pts
    live = np.zeros(f_cap, bool)
    live[:140] = valid
    perm = rng.permutation(f_cap)
    xy, live = xy[perm], live[perm]
    ids = np.arange(f_cap, dtype=np.int32)
    flow = (rng.normal(size=xy.shape) + [4.0, 0.5]).astype(np.float32)
    flow_valid = live & (rng.random(f_cap) < 0.7)
    pyr0 = [np.asarray(p) for p in jax_build_pyramid(to_jax(world_frames[0]), 3)]
    pyr1 = [np.asarray(p) for p in jax_build_pyramid(to_jax(world_frames[1]), 3)]

    jst = jax_tracker_init(tuple(to_jax(p) for p in pyr0), to_jax(xy), to_jax(ids),
                           to_jax(live), to_jax(flow), to_jax(flow_valid), jnp.float32(2.0))
    tst = tracker_init(tuple(to_torch(p) for p in pyr0), to_torch(xy), to_torch(ids),
                       to_torch(live), to_torch(flow), to_torch(flow_valid),
                       torch.tensor(2.0, dtype=torch.float32))
    jcfg, tcfg = JFrontendConfig(), FrontendConfig()
    jnew, jstats = jax.jit(lambda s, p: jax_track_step(s, p, jcfg, flow_back=False))(
        jst, tuple(to_jax(p) for p in pyr1))
    tnew, tstats = track_step(tst, tuple(to_torch(p) for p in pyr1), tcfg, flow_back=False)

    assert not bool(tstats.hinted) and not bool(jstats.hinted)
    assert float(tnew.pred_err) == NO_FLOW == float(jnew.pred_err)
    assert_equal(tnew.feat_valid, jnew.feat_valid, "feat_valid")
    assert_equal(tnew.flow_valid, jnew.flow_valid, "flow_valid")
    assert_equal(tstats.num_tracked, jstats.num_tracked, "num_tracked")
    ok = np.asarray(jnew.feat_valid)
    assert ok.sum() > 0.5 * live.sum()
    assert_close(tnew.feat_xy, jnew.feat_xy, atol=POS_TOL, what="feat_xy")
    assert_close(tnew.flow_xy, jnew.flow_xy, atol=POS_TOL, what="flow_xy")
    assert_close(tstats.av_parallax, jstats.av_parallax, atol=POS_TOL, what="av_parallax")
    assert_close(tstats.percent_lost, jstats.percent_lost, atol=1e-6, what="percent_lost")


@pytest.mark.parametrize("max_corners,min_distance", [(300, 30.0), (300, 12.0), (40, 12.0)])
def test_maxpool_detection_matches_reference(world_frames, max_corners, min_distance):
    img = world_frames[1]
    want = jax_detect(to_jax(img), max_corners=max_corners, min_distance=min_distance,
                      nms="maxpool")
    got = detect_corners(to_torch(img), max_corners=max_corners, min_distance=min_distance,
                         nms="maxpool")
    assert_equal(got[2], want[2], "valid")
    assert_equal(got[0], want[0], "xy")
    assert_close(got[1], want[1], atol=1e-3, rtol=1e-5, what="response")
    n = int(np.sum(np.asarray(want[2])))
    greedy = int(detect_corners(to_torch(img), max_corners=max_corners,
                                min_distance=min_distance)[2].sum())
    assert 0 < n <= greedy
    xy = got[0].numpy()[got[2].numpy()]
    d = np.linalg.norm(xy[:, None] - xy[None], axis=-1) + np.eye(len(xy)) * 1e9
    assert d.min() >= min_distance


def test_detect_corners_refuses_unknown_nms(world_frames):
    with pytest.raises(ValueError, match="nms"):
        detect_corners(to_torch(world_frames[0]), nms="sorted")
