"""Offline replay of the port (``run_vo(chunk_size > 1)``,
``VOEngine.replay_chunk``, ``preload_device``) against its own streaming path
and against the JAX package's chunked replay.

Tolerances:
- chunked against streamed in the port: the same step calls on the same
  inputs, so poses within 1e-5 (they are bitwise equal on the CPU) and
  identical keyframe flags, as ``tests/test_engine.py`` holds the reference;
- the batched preprocessing (pyramid, Shi-Tomasi response, peak count) over
  ``[K, H, W]``: equal to the port's per-frame results element for element,
  and to the JAX batched results at the filter tests' tolerances;
- port chunked against JAX chunked: both draw PnP's samples from the same
  threefry stream, so the keyframe count is equal and the keyframe ATE within
  1e-4 m, as ``test_end_to_end_ate_matches_reference``
  (``test_torch_trajectory.py`` holds every frame).
"""

import dataclasses

import numpy as np
import pytest

from stereo_vo_tpu.core.camera import CameraInfo as JCameraInfo
from stereo_vo_tpu.core.config import BackendConfig, FrontendConfig, PipelineConfig
from stereo_vo_tpu.data.synthetic import SyntheticStereoSequence
from stereo_vo_tpu.engine import run_vo as jax_run_vo
from stereo_vo_tpu.eval.ate import absolute_trajectory_error
from stereo_vo_tpu.ops import shi_tomasi as jst
from stereo_vo_tpu.ops.pyramid import build_pyramid as jax_build_pyramid

from stereo_vo_tpu_torch.data.stream import StereoFrame
from stereo_vo_tpu_torch.data.synthetic import SyntheticStereoSequence as TSynthetic
from stereo_vo_tpu_torch.ops import shi_tomasi as tst
from stereo_vo_tpu_torch.ops.pyramid import build_pyramid

from torch_port_helpers import (
    assert_close,
    assert_equal,
    cpu_engine,
    cpu_run_vo,
    port_camera,
    port_config,
    to_jax,
    to_torch,
)

JCAM = JCameraInfo(focal=400.0, cx=160.0, cy=120.0, baseline=0.5)
SHAPE = (240, 320)
N_FRAMES = 13
CHUNK = 4
POSE_TOL = 1e-5
ATE_TOL = 1e-4
FILTER_ATOL, FILTER_RTOL = 1e-5, 2e-7     # tests/test_torch_filters.py


def _config():
    return PipelineConfig(
        camera=JCAM,
        frontend=FrontendConfig(min_distance=12.0, parallax_thresh=10.0),
        backend=BackendConfig(feature_capacity=384, landmark_capacity=1024, max_lm_iters=8),
    )


def _world_kwargs():
    return dict(n_frames=N_FRAMES, shape=SHAPE, n_points=500, seed=11, speed=0.35,
                yaw_rate=0.004, point_depth=(5.0, 18.0))


@pytest.fixture(scope="module")
def frames():
    return list(TSynthetic(cam=port_camera(JCAM), **_world_kwargs()))


@pytest.fixture(scope="module")
def streamed(frames):
    return cpu_run_vo(iter(frames), port_config(_config()))


@pytest.fixture(scope="module")
def chunked(frames):
    return cpu_run_vo(iter(frames), port_config(_config()), chunk_size=CHUNK, preload_device=True)


def _kf(run):
    return [s["is_keyframe"] for s in run.frame_stats]


def _kf_ate(poses, gt, stats):
    kf = np.array([s["is_keyframe"] for s in stats])
    return absolute_trajectory_error(poses[kf], gt[kf], align=False)["rmse"], int(kf.sum())


def test_chunked_equals_streamed(streamed, chunked):
    assert len(chunked.poses) == len(streamed.poses) == N_FRAMES
    assert_close(chunked.poses, streamed.poses, atol=POSE_TOL, what="poses")
    assert _kf(chunked) == _kf(streamed)
    # bootstrap streamed, then three full chunks and no tail
    assert len(chunked.frame_seconds) == 1 and len(chunked.chunk_seconds) == 3
    assert chunked.preload_misses == 0 and chunked.frames_per_sec > 0
    assert [s["frame"] for s in chunked.frame_stats] == list(range(N_FRAMES))


def test_tail_shorter_than_a_chunk_goes_through_step(frames, streamed):
    """12 frames: bootstrap, two chunks of 4, and a 3-frame tail of steps."""
    run = cpu_run_vo(iter(frames[:12]), port_config(_config()), chunk_size=CHUNK)
    assert len(run.chunk_seconds) == 2
    assert len(run.frame_seconds) == 1 + 3
    assert_close(run.poses, streamed.poses[:12], atol=POSE_TOL, what="poses")
    assert _kf(run) == _kf(streamed)[:12]


def test_max_frames_with_preload(frames, streamed):
    run = cpu_run_vo(iter(frames), port_config(_config()), chunk_size=CHUNK,
                 preload_device=True, max_frames=10)
    assert len(run.poses) == 10 and run.preload_misses == 0
    assert_close(run.poses, streamed.poses[:10], atol=POSE_TOL, what="poses")


def test_replay_chunk_returns_stacked_outputs(frames):
    cfg = port_config(_config())
    engine = cpu_engine(cfg, SHAPE)
    state, _ = engine.bootstrap(engine.init_state(), frames[0].left, frames[0].right)
    lefts = np.stack([f.left for f in frames[1:4]])
    rights = np.stack([f.right for f in frames[1:4]])
    state_c, poses, summaries = engine.replay_chunk(state, lefts, rights)
    assert tuple(poses.shape) == (3, 7) and tuple(summaries.shape) == (3, 19)
    st = state
    for k, f in enumerate(frames[1:4]):
        st, out = engine.step(st, f.left, f.right)
        assert_equal(summaries[k], out.summary, f"summary {k}")
        assert_equal(poses[k], out.pose_cw, f"pose {k}")
    assert int(state_c.frame_idx) == int(st.frame_idx) == 4


@pytest.mark.parametrize("what", ["pyramid", "min_eig_response", "count_quality_peaks"])
def test_batched_preprocessing(frames, what):
    """The chunk's one batched pass equals the per-frame results exactly and
    the JAX batched pass at the filter tolerances."""
    lefts = np.stack([f.left for f in frames[:3]]).astype(np.float32)
    t_lefts = to_torch(lefts)
    if what == "pyramid":
        got = build_pyramid(t_lefts, 3)
        want = jax_build_pyramid(to_jax(lefts), 3)
        for lvl, (g, w) in enumerate(zip(got, want)):
            assert_close(g, w, atol=FILTER_ATOL, rtol=FILTER_RTOL, what=f"level {lvl}")
            for k in range(3):
                assert_equal(g[k], build_pyramid(t_lefts[k], 3)[lvl], f"level {lvl} frame {k}")
    elif what == "min_eig_response":
        got = tst.min_eig_response(t_lefts)
        want = np.asarray(jst.min_eig_response(to_jax(lefts)))
        assert_close(got, want, atol=4e-7 * float(want.max()), rtol=1e-5)
        for k in range(3):
            assert_equal(got[k], tst.min_eig_response(t_lefts[k]), f"frame {k}")
    else:
        resp = tst.min_eig_response(t_lefts)
        got = tst.count_quality_peaks(t_lefts, 0.1, 3, resp=resp)
        assert_equal(got, jst.count_quality_peaks(to_jax(lefts), 0.1, 3))
        for k in range(3):
            assert_equal(got[k], tst.count_quality_peaks(t_lefts[k], 0.1, 3), f"frame {k}")


def test_chunked_ate_matches_jax_chunked(chunked):
    world = SyntheticStereoSequence(cam=JCAM, **_world_kwargs())
    ref = jax_run_vo(world, _config(), chunk_size=CHUNK)
    assert len(ref.poses) == len(chunked.poses)
    ate, n_kf = _kf_ate(chunked.poses, world.gt_poses, chunked.frame_stats)
    ref_ate, ref_kf = _kf_ate(ref.poses, world.gt_poses, ref.frame_stats)
    assert n_kf == ref_kf >= 4
    assert abs(ate - ref_ate) < ATE_TOL, (ate, ref_ate)


def test_preload_survives_late_bootstrap(frames):
    """Three dark frames before the world: bootstrap lands on frame 3, the
    chunks start at positions 4 and 8, and every chunk still hits the
    preload (the JAX package's round-3 bug keyed it by chunk alignment)."""
    cfg = port_config(_config())
    dark = [StereoFrame(left=np.zeros(SHAPE, np.uint8), right=np.zeros(SHAPE, np.uint8),
                        stamp=i / 11.0, index=i) for i in range(3)]
    seq = dark + [dataclasses.replace(f, index=i + 3, stamp=(i + 3) / 11.0)
                  for i, f in enumerate(frames[:9])]
    run = cpu_run_vo(iter(seq), cfg, chunk_size=CHUNK, preload_device=True)
    assert run.preload_misses == 0
    assert len(run.poses) == len(seq) and np.isfinite(run.poses).all()
    kf = np.array(_kf(run))
    assert not kf[:3].any() and kf[3]
    assert len(run.chunk_seconds) == 2
    ref = cpu_run_vo(iter(seq), cfg, chunk_size=CHUNK)
    assert ref.preload_misses == 0
    assert_close(run.poses, ref.poses, atol=POSE_TOL, what="poses")
