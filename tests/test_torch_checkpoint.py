"""Checkpoint / resume and per-frame metrics of the port against the JAX
package.

- Checkpoints cross the packages both ways: a JAX ``save_state`` file loads
  in the port's ``load_state`` and a port file in the JAX ``load_state``, with
  every leaf equal (bitwise, same dtype) and the same resume index.
- Resume from a streamed checkpoint reproduces the straight run's remaining
  trajectory bitwise on the CPU (the JAX package's
  ``test_checkpoint_resume_bitwise``), and resume from a chunked checkpoint
  the straight chunked run's tail.
- ``metrics.jsonl`` rows equal ``frame_stats`` and carry the JAX rows' keys in
  the JAX order (``{"frame": i, **parse_summary row}``).
"""

import json
import os

import numpy as np
import pytest

import jax
from stereo_vo_tpu.core.camera import CameraInfo as JCameraInfo
from stereo_vo_tpu.core.config import BackendConfig, FrontendConfig, PipelineConfig
from stereo_vo_tpu.engine import checkpoint as jax_checkpoint
from stereo_vo_tpu.engine.step import SUMMARY_KEYS as JAX_SUMMARY_KEYS
from stereo_vo_tpu.engine.step import VOEngine as JVOEngine

from stereo_vo_tpu_torch.data.synthetic import SyntheticStereoSequence
from stereo_vo_tpu_torch.engine.checkpoint import load_state, save_state
from stereo_vo_tpu_torch.engine.convert import state_to_numpy

from torch_port_helpers import (
    assert_close,
    assert_equal,
    cpu_engine,
    cpu_run_vo,
    port_camera,
    port_config,
    to_jax,
)

JCAM = JCameraInfo(focal=400.0, cx=160.0, cy=120.0, baseline=0.5)
SHAPE = (240, 320)


def _config():
    return PipelineConfig(
        camera=JCAM,
        frontend=FrontendConfig(min_distance=12.0, parallax_thresh=10.0),
        backend=BackendConfig(feature_capacity=384, landmark_capacity=1024, max_lm_iters=8),
    )


@pytest.fixture(scope="module")
def frames():
    return list(SyntheticStereoSequence(
        cam=port_camera(JCAM), n_frames=13, shape=SHAPE, n_points=500, seed=11,
        speed=0.35, yaw_rate=0.004, point_depth=(5.0, 18.0)))


@pytest.fixture(scope="module")
def jax_bootstrap_ckpt(frames, tmp_path_factory):
    """A JAX ``save_state`` file of the JAX bootstrap state on frame 0."""
    engine = JVOEngine(_config(), SHAPE)
    state, _ = engine.bootstrap(engine.init_state(), to_jax(frames[0].left),
                                to_jax(frames[0].right))
    path = str(tmp_path_factory.mktemp("jax_ckpt") / "checkpoint.npz")
    jax_checkpoint.save_state(path, state, 1)
    return path, [np.asarray(x) for x in jax.tree.leaves(state)]


@pytest.fixture(scope="module")
def chunked_run(frames, tmp_path_factory):
    """13 frames, chunks of 4, checkpoint every 7: the checkpoint lands on the
    chunk boundary after frame 8 (resume index 9)."""
    out = str(tmp_path_factory.mktemp("chunked"))
    run = cpu_run_vo(iter(frames), port_config(_config()), chunk_size=4, checkpoint_every=7,
                 out_dir=out)
    return run, out


def test_jax_checkpoint_loads_in_port(jax_bootstrap_ckpt):
    path, jax_leaves = jax_bootstrap_ckpt
    state, next_idx = load_state(path, cpu_engine(port_config(_config()), SHAPE))
    assert next_idx == 1
    got = state_to_numpy(state)
    assert len(got) == len(jax_leaves)
    for i, (g, w) in enumerate(zip(got, jax_leaves)):
        assert g.dtype == w.dtype, i
        assert_equal(g, w, f"leaf {i}")
    assert bool(state.initialized)


def test_port_checkpoint_loads_in_jax(frames, tmp_path):
    cfg = port_config(_config())
    engine = cpu_engine(cfg, SHAPE)
    state, _ = engine.bootstrap(engine.init_state(), frames[0].left, frames[0].right)
    for f in frames[1:4]:
        state, _ = engine.step(state, f.left, f.right)
    path = str(tmp_path / "checkpoint.npz")
    save_state(path, state, 4)
    jstate, next_idx = jax_checkpoint.load_state(path, JVOEngine(_config(), SHAPE))
    assert next_idx == 4
    want = state_to_numpy(state)
    got = [np.asarray(x) for x in jax.tree.leaves(jstate)]
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype, i
        assert_equal(g, w, f"leaf {i}")


@pytest.mark.parametrize("fault", ["shape", "dtype"])
def test_load_state_checks_leaves(jax_bootstrap_ckpt, tmp_path, fault):
    path, _ = jax_bootstrap_ckpt
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files}
    leaf = arrays["leaf_5"]      # tracker.feat_xy, float32 [F, 2]
    arrays["leaf_5"] = leaf[:-1] if fault == "shape" else leaf.astype(np.float64)
    bad = str(tmp_path / "bad.npz")
    np.savez(bad, **arrays)
    with pytest.raises(ValueError, match="leaf 5"):
        load_state(bad, cpu_engine(port_config(_config()), SHAPE))


def test_port_resumes_from_jax_checkpoint(frames, jax_bootstrap_ckpt):
    """A JAX bootstrap checkpoint starts the port's replay at frame 1; the
    trajectory stays with the port's own straight run (the two bootstrap
    states differ by f32 rounding only)."""
    cfg = port_config(_config())
    run = cpu_run_vo(iter(frames[:6]), cfg, resume_from=jax_bootstrap_ckpt[0])
    straight = cpu_run_vo(iter(frames[:6]), cfg)
    assert [s["frame"] for s in run.frame_stats] == [1, 2, 3, 4, 5]
    assert np.isfinite(run.poses).all()
    assert [s["is_keyframe"] for s in run.frame_stats] == \
        [s["is_keyframe"] for s in straight.frame_stats[1:]]
    assert_close(run.poses, straight.poses[1:], atol=1e-3, what="poses")


def test_streamed_resume_is_bitwise(frames, tmp_path):
    cfg = port_config(_config())
    out = str(tmp_path / "a")
    run_a = cpu_run_vo(iter(frames[:12]), cfg, out_dir=out, checkpoint_every=7)
    ckpt = os.path.join(out, "checkpoint.npz")
    _, next_idx = load_state(ckpt, cpu_engine(cfg, SHAPE))
    assert next_idx == 7
    run_b = cpu_run_vo(iter(frames[:12]), cfg, resume_from=ckpt)
    assert [s["frame"] for s in run_b.frame_stats] == list(range(7, 12))
    assert_equal(run_b.poses, run_a.poses[7:], "resumed poses")
    assert run_b.frame_stats == run_a.frame_stats[7:]


def test_chunked_resume_reproduces_tail(frames, chunked_run):
    run_a, out = chunked_run
    ckpt = os.path.join(out, "checkpoint.npz")
    _, next_idx = load_state(ckpt, cpu_engine(port_config(_config()), SHAPE))
    assert next_idx == 9
    run_b = cpu_run_vo(iter(frames), port_config(_config()), chunk_size=4, resume_from=ckpt)
    assert len(run_b.chunk_seconds) == 1
    assert [s["frame"] for s in run_b.frame_stats] == [9, 10, 11, 12]
    assert_equal(run_b.poses, run_a.poses[9:], "resumed poses")
    assert run_b.frame_stats == run_a.frame_stats[9:]


def test_metrics_rows_match_frame_stats(chunked_run):
    run, out = chunked_run
    with open(os.path.join(out, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert rows == run.frame_stats
    assert [r["frame"] for r in rows] == list(range(13))
    for r in rows:
        assert list(r) == ["frame", *JAX_SUMMARY_KEYS]
