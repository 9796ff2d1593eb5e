"""The port's step as the reference's decision structure, path by path.

``VOEngine.step`` takes the reference's decisions in the reference's order,
each with ``engine/graphs.py::cond`` (one host read of its predicate on the
CPU, a conditional node in the card's step graph). Here, on the CPU:

- each path of the step against the JAX package's jitted step on the same
  state and frame: the JAX engine streams the 240x320 world of
  ``tests/test_torch_engine.py`` (with ``ba_compact_landmarks`` = 80, so that
  its keyframes take both solves) and its state before frame k goes into the
  port (``engine/convert.py``); both step once. The paths: no detections (a
  blank frame), the gate closed, PnP failed (all but five tracked features
  dropped from the state), a keyframe with the compacted solve, a keyframe with the full
  solve, the flow-hinted short pyramid, the full pyramid. Each is checked to
  be the path it names (the flags, and which solve ran). Tolerances are
  ``tests/test_torch_trajectory.py``'s: integer fields equal, the pose within
  1e-4, BA costs within relative 1e-3; the new state's integer leaves equal
  and its float leaves within ``tests/test_torch_engine.py``'s state bounds;
- ``graphs.warming`` runs both sides of every cond of a step: the same
  result as the plain step, bitwise, and the two sides agree in structure;
- ``track_step`` with and without the CPU's live-slot compaction: bitwise
  equal, hinted and full;
- ``cond`` itself: one read and one side outside a capture, both sides
  checked and the untaken side's launches not counted while warming.
"""

import numpy as np
import pytest
import torch

import jax
from stereo_vo_tpu.core.camera import CameraInfo as JCameraInfo
from stereo_vo_tpu.core.config import BackendConfig, FrontendConfig, PipelineConfig
from stereo_vo_tpu.data.synthetic import SyntheticStereoSequence
from stereo_vo_tpu.engine.step import VOEngine as JVOEngine

from stereo_vo_tpu_torch.engine import graphs
from stereo_vo_tpu_torch.engine import step as step_module
from stereo_vo_tpu_torch.engine.convert import state_from_numpy, state_to_numpy
from stereo_vo_tpu_torch.engine.step import SUMMARY_KEYS, parse_summary
from stereo_vo_tpu_torch.frontend.track import track_step
from stereo_vo_tpu_torch.ops.lk import lk_level_pass
from stereo_vo_tpu_torch.ops.pyramid import build_pyramid

from torch_port_helpers import assert_close, assert_equal, cpu_engine, port_config, to_jax

JCAM = JCameraInfo(focal=400.0, cx=160.0, cy=120.0, baseline=0.5)
SHAPE = (240, 320)
N_FRAMES = 8
COMPACT_LANDMARKS = 80          # the world's keyframes hold 65-107 live landmarks
TRAJ_TOL = 1e-4                 # tests/test_torch_trajectory.py
BA_RTOL = 1e-3
# (frame, what is done to the reference's state or frame first)
PATHS = {
    "no_detections": (4, "blank frame"),
    "gate_closed": (2, None),
    "pnp_failed": (5, "five tracked features"),
    "keyframe_compact": (3, None),
    "keyframe_full": (7, None),
    "hinted": (4, None),
    "full_pyramid": (1, None),
}


def _config():
    return PipelineConfig(
        camera=JCAM,
        frontend=FrontendConfig(min_distance=12.0, parallax_thresh=10.0),
        backend=BackendConfig(feature_capacity=384, landmark_capacity=1024, max_lm_iters=8,
                              ba_compact_landmarks=COMPACT_LANDMARKS),
    )


@pytest.fixture(scope="module")
def reference():
    """The JAX engine, the world's frames and its state before each frame."""
    world = SyntheticStereoSequence(cam=JCAM, n_frames=N_FRAMES, shape=SHAPE, n_points=500,
                                    seed=11, speed=0.35, yaw_rate=0.004,
                                    point_depth=(5.0, 18.0))
    engine = JVOEngine(_config(), SHAPE)
    frames = [world.render(i) for i in range(N_FRAMES)]
    state = engine.init_state()
    states = []
    for left, right in frames:
        states.append(state)
        fn = engine.step if bool(state.initialized) else engine.bootstrap
        state, _ = fn(state, to_jax(left), to_jax(right))
    return engine, frames, states


def _path_inputs(reference, path):
    """``(reference state, left, right)`` for a path, modified as ``PATHS``
    says."""
    _, frames, states = reference
    k, change = PATHS[path]
    state = states[k]
    left, right = frames[k]
    if change == "blank frame":
        left, right = np.zeros_like(left), np.zeros_like(right)
    elif change == "five tracked features":
        # most of the tracked set lost: the gate accepts, and PnP cannot reach
        # its minimum inlier count
        valid = np.array(state.tracker.feat_valid)
        valid[np.nonzero(valid)[0][5:]] = False
        state = state._replace(tracker=state.tracker._replace(feat_valid=to_jax(valid)))
    return state, left, right


@pytest.mark.parametrize("path", list(PATHS))
def test_step_path_matches_reference(reference, path, monkeypatch):
    jstate0, left, right = _path_inputs(reference, path)
    jstate, jout = reference[0].step(jstate0, to_jax(left), to_jax(right))
    leaves = [np.array(x) for x in jax.tree.leaves(jstate0)]
    cfg = port_config(_config())
    engine = cpu_engine(cfg, SHAPE)
    solves = []
    solve = step_module.bundle_adjust

    def recording(window, cam, bcfg, compact=None):
        solves.append(compact)
        return solve(window, cam, bcfg, compact=compact)

    monkeypatch.setattr(step_module, "bundle_adjust", recording)
    tstate, tout = engine.step(state_from_numpy(leaves, cfg, SHAPE, device="cpu"), left, right)

    jpose, jrow = parse_summary(np.asarray(jout.summary))
    tpose, trow = parse_summary(tout.summary)
    for k in SUMMARY_KEYS:
        if isinstance(jrow[k], (bool, int)):
            assert trow[k] == jrow[k], (path, k, trow[k], jrow[k])
        elif k.startswith("ba_"):
            assert trow[k] == pytest.approx(jrow[k], rel=BA_RTOL, abs=1e-6), (path, k)
        else:
            assert trow[k] == pytest.approx(jrow[k], abs=1e-3), (path, k)
    assert_close(tpose, jpose, atol=TRAJ_TOL, what=f"{path}: published pose")
    got, want = state_to_numpy(tstate), [np.asarray(x) for x in jax.tree.leaves(jstate)]
    n_pyr = cfg.frontend.lk_max_level + 1
    for i, (g, w) in enumerate(zip(got, want)):
        if i < n_pyr:
            assert_close(g, w, atol=1e-3, rtol=1e-6, what=f"{path}: pyramid {i}")
        elif np.issubdtype(w.dtype, np.floating):
            assert_close(g, w, atol=2e-3, rtol=1e-3, what=f"{path}: leaf {i}")
        else:
            assert_equal(g, w, f"{path}: leaf {i}")

    # the path is the one its name says
    taken = {
        "no_detections": trow["num_tracked"] == 0 and not trow["hinted"]
        and trow["num_detected"] < cfg.frontend.min_detected,
        "gate_closed": trow["num_tracked"] > 0 and trow["num_inliers"] == 0
        and trow["pnp_ok"] and not trow["is_keyframe"],
        "pnp_failed": not trow["pnp_ok"] and not trow["is_keyframe"],
        "keyframe_compact": trow["is_keyframe"] and solves == [True],
        "keyframe_full": trow["is_keyframe"] and solves == [False],
        "hinted": trow["hinted"],
        "full_pyramid": not trow["hinted"] and trow["num_tracked"] > 0,
    }
    assert taken[path], (path, trow, solves)
    assert not solves or trow["is_keyframe"]


@pytest.fixture(scope="module")
def port_run(reference):
    """The port's state before frame 4 (a hinted cruise frame) and frame 7
    (a keyframe with the full solve), from the reference's states."""
    cfg = port_config(_config())
    _, frames, states = reference
    return cfg, {k: (state_from_numpy([np.array(x) for x in jax.tree.leaves(states[k])], cfg,
                                      SHAPE, device="cpu"), frames[k]) for k in (1, 4, 7)}


@pytest.mark.parametrize("frame", [4, 7])
def test_warming_runs_both_sides_and_keeps_the_result(port_run, frame):
    cfg, states = port_run
    state, (left, right) = states[frame]
    engine = cpu_engine(cfg, SHAPE)
    plain_state, plain_out = engine.step(state, left, right)
    with graphs.warming():
        warm_state, warm_out = engine.step(state, left, right)
    for a, b in zip(graphs.flatten((plain_state, plain_out))[0],
                    graphs.flatten((warm_state, warm_out))[0]):
        assert_equal(a, b, f"frame {frame}")


@pytest.mark.parametrize("frame", [1, 4])
def test_track_step_compaction_is_bitwise_full_width(port_run, frame):
    """The CPU's compacted level passes against the full-width ones (the
    card's way), hinted (frame 4) and on the full pyramid (frame 1)."""
    import dataclasses

    cfg, states = port_run
    state, (left, _) = states[frame]
    pyr = tuple(build_pyramid(torch.from_numpy(left).to(torch.float32),
                              cfg.frontend.lk_max_level))
    live = int(state.tracker.feat_valid.sum())
    assert 0 < live <= cfg.frontend.lk_compact_slots < state.tracker.feat_valid.shape[0]
    compacted = track_step(state.tracker, pyr, cfg.frontend)
    full = track_step(state.tracker, pyr,
                      dataclasses.replace(cfg.frontend, lk_compact_slots=0))
    assert bool(compacted[1].hinted) == (frame == 4)
    for a, b in zip(graphs.flatten(compacted)[0], graphs.flatten(full)[0]):
        assert_equal(a, b, f"frame {frame}")


def test_cond_reads_once_and_runs_one_side():
    ran = []
    out = graphs.cond(torch.tensor(True), lambda x: ran.append("t") or x + 1,
                      lambda x: ran.append("f") or x - 1, (torch.tensor(1.0),))
    assert ran == ["t"] and float(out) == 2.0
    reads = graphs._ctx.reads
    graphs.cond(torch.tensor(False), lambda: ran.append("t2"), lambda: ran.append("f2"))
    assert ran[-1] == "f2" and graphs._ctx.reads == reads + 1
    with pytest.raises(ValueError):
        graphs.cond(torch.tensor([True, False]), lambda: None, lambda: None)


def test_cond_warming_checks_both_sides():
    def counted(x):
        lk_level_pass.launches += 1
        return x * 2

    before = lk_level_pass.launches
    with graphs.warming():
        out = graphs.cond(torch.tensor(False), counted, lambda x: x, (torch.tensor(3.0),))
        assert float(out) == 3.0 and lk_level_pass.launches == before
        out = graphs.cond(torch.tensor(True), counted, lambda x: x, (torch.tensor(3.0),))
        assert float(out) == 6.0 and lk_level_pass.launches == before + 1
        with pytest.raises(ValueError):
            graphs.cond(torch.tensor(True), lambda: torch.zeros(2),
                        lambda: torch.zeros(3))
        with pytest.raises(ValueError):
            graphs.cond(torch.tensor(True), lambda: torch.zeros(2),
                        lambda: torch.zeros(2, dtype=torch.int32))
    lk_level_pass.launches = before
