"""The port held to the JAX package on its photo-textured long-horizon world.

The world is ``tests/test_long_sequence.py``'s stand-in for KITTI: the
``kitti00`` camera at 376x1241, the photograph as the background texture,
3000 points, 0.9 m and 0.004 rad per frame, 161 frames, seeds 11 and 23.
The JAX package's ``run_vo(chunk_size=32)`` over each is stored in
``tests/fixtures/jax_reference/kitti00_photo_s{11,23}_w161_c32.npz``
(``tests/fixtures/make_jax_reference.py``), with three reruns whose bundle
adjustments had every input nudged by at most one ulp: the reference's own
float32 spread on that world.

What the bisection of the port against the reference found:

- From the reference's own state, every frame the port steps holds to the
  reference's: integer fields equal, poses within ``TRAJ_TOL``, BA costs
  within ``BA_RTOL`` (``test_one_step_from_the_reference_state``), except at
  the frames where the reference does not hold to itself. That is frame 2 of
  both seeds, the third keyframe: a window of three keyframes 0.9 m apart
  whose reduced camera system has condition ~1.1e8, where the bundle
  adjustment moves weakly seen landmarks by metres on a one-ulp change of
  its input. There the nudged reference reruns depart from the reference by
  up to 8.8e-3 in the final BA cost and 2.3e-4 in the pose, and the port's
  departure must lie within ``SPREAD_FACTOR`` times theirs.
- Run free (``test_photo_world_held_to_reference``), the port holds to the
  reference exactly up to its first departure, which comes no earlier than
  the nudged reruns' first. After it the weak landmarks differ, and the
  trajectories part as the nudged reruns' do; the run is held by its
  keyframe count, within the range of the reference runs (the stored run
  and its reruns), and by its aligned keyframe ATE, within ``ATE_RTOL`` of
  that range. The first departure, what departed and by how much, and the
  reruns' spread at that frame are printed.

Tier-1 runs the one-step hold over frames 0-11 of both seeds and the free
run over frames 0-47 of seed 11 (the 161-frame world rendered, the run stopped by
``max_frames``: the world's depth range depends on its frame count). The
``slow`` test runs both seeds over all 161 frames (~10 minutes).
"""

import os

import numpy as np
import pytest

from stereo_vo_tpu_torch.core.config import load_config
from stereo_vo_tpu_torch.data.synthetic import SyntheticStereoSequence, load_sample_photo
from stereo_vo_tpu_torch.eval.parity import (
    INT_KEYS,
    beyond_spread,
    departures,
    divergence_hold,
    frame_differences,
    keyframe_ate,
    reference_spread,
    run_summaries,
)

from torch_port_helpers import cpu_engine, cpu_run_vo

# test_torch_trajectory.py's rules
TRAJ_TOL = 1e-4
BA_RTOL = 1e-3
# a departure the nudged reference reruns also make: within this many times
# their largest at the frame
SPREAD_FACTOR = 2.0
ATE_RTOL = 0.10
TIER1_FRAMES = 48
ONE_STEP_FRAMES = 12
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                        "jax_reference")


def _reference(seed):
    return np.load(os.path.join(FIXTURES, f"kitti00_photo_s{seed}_w161_c32.npz"))


def _world(ref):
    cfg = load_config(str(ref["config"]))
    assert str(ref["texture"]) == "grace_hopper"
    world = SyntheticStereoSequence(
        cam=cfg.camera, n_frames=int(ref["n_frames"]), shape=tuple(int(s) for s in ref["shape"]),
        n_points=int(ref["n_points"]), seed=int(ref["seed"]), speed=float(ref["speed"]),
        yaw_rate=float(ref["yaw_rate"]), texture=load_sample_photo())
    return cfg, world


def _spread(ref, n):
    return reference_spread(ref["summaries"][:n], ref["spread_summaries"][:, :n], TRAJ_TOL,
                            BA_RTOL)


def _hold(got, ref, gt, what):
    report = divergence_hold(got, ref["summaries"], ref["spread_summaries"], gt, TRAJ_TOL,
                             BA_RTOL, SPREAD_FACTOR, ATE_RTOL)
    print(f"{what}: {report}")
    assert not report["failures"], f"{what}: {report['failures']}"
    return report


def test_photo_fixtures_describe_their_world():
    for seed in (11, 23):
        ref = _reference(seed)
        n = int(ref["n_frames"])
        assert n == 161 and int(ref["chunk_size"]) == 32 and int(ref["seed"]) == seed
        assert ref["summaries"].shape == (n, 19) and np.isfinite(ref["summaries"]).all()
        assert ref["spread_summaries"].shape == (3, n, 19)
        assert tuple(ref["texture_shape"]) == load_sample_photo().shape
        assert ref["summaries"][:, 7].sum() >= 30          # the window cycles
        assert _spread(ref, n)[1], "the nudged reruns never depart"


@pytest.mark.parametrize("seed", [11, 23])
def test_one_step_from_the_reference_state(seed):
    """Each of frames 0-11 stepped by the port from the JAX engine's own
    state after the frame before, against the JAX step."""
    import jax

    from stereo_vo_tpu.core.config import load_config as jax_load_config
    from stereo_vo_tpu.engine.step import VOEngine as JaxEngine

    from stereo_vo_tpu_torch.engine.convert import state_from_numpy

    ref = _reference(seed)
    cfg, world = _world(ref)
    shape = tuple(int(s) for s in ref["shape"])
    jeng = JaxEngine(jax_load_config(str(ref["config"])), shape)
    eng = cpu_engine(cfg, shape)
    jstate = jeng.init_state()
    spread, _ = _spread(ref, ONE_STEP_FRAMES)
    got, want = [], []
    for k in range(ONE_STEP_FRAMES):
        left, right = world.render(k)
        leaves = [np.asarray(x) for x in jax.tree.leaves(jstate)]
        state = state_from_numpy(leaves, cfg, shape, device="cpu")
        step = eng.step if bool(state.initialized) else eng.bootstrap
        got.append(step(state, left, right)[1].summary.numpy())
        jstep = jeng.step if bool(jstate.initialized) else jeng.bootstrap
        jstate, jout = jstep(jstate, jax.numpy.asarray(left), jax.numpy.asarray(right))
        want.append(np.asarray(jout.summary))
    want = np.stack(want)
    np.testing.assert_array_equal(want, ref["summaries"][:ONE_STEP_FRAMES],
                                  err_msg="streamed JAX run vs the stored chunked run")
    d = frame_differences(np.stack(got), want)
    for k in range(ONE_STEP_FRAMES):
        why = departures(d, k, TRAJ_TOL, BA_RTOL)
        print(f"frame {k}: |dq| {d['dq'][k]:.3g} |dt| {d['dt'][k]:.3g}, BA costs "
              f"{d['ba_initial_cost'][k]:.3g} {d['ba_final_cost'][k]:.3g}"
              + (f", departs {why}, nudged reruns up to "
                 f"{ {f: float(spread[f][k]) for f in why} }" if why else ""))
        assert not beyond_spread(why, spread, k, SPREAD_FACTOR), f"frame {k}: {why}"
        assert not any(f in INT_KEYS for f in why), f"frame {k}: {why}"


def _free_run(seed, n):
    ref = _reference(seed)
    cfg, world = _world(ref)
    run = cpu_run_vo(world, cfg, chunk_size=int(ref["chunk_size"]), max_frames=n)
    got = run_summaries(run)
    assert got.shape == (n, 19) and np.isfinite(got).all()
    return got, ref, world.gt_poses


def test_photo_world_held_to_reference():
    got, ref, gt = _free_run(11, TIER1_FRAMES)
    _hold(got, ref, gt, f"seed 11, frames 0-{TIER1_FRAMES - 1}")


@pytest.mark.slow
@pytest.mark.parametrize("seed", [11, 23])
def test_photo_world_full_length(seed):
    n = int(_reference(seed)["n_frames"])
    got, ref, gt = _free_run(seed, n)
    _hold(got, ref, gt, f"seed {seed}, all {n} frames")
    assert keyframe_ate(got, gt)[1] >= 30
