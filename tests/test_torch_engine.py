"""Slice-level parity of the port's engine with the JAX package, and the
port's isolation from JAX.

- ``state_from_numpy`` / ``state_to_numpy`` carry a JAX ``VOState`` into the
  port and back unchanged.
- Step parity: the JAX engine runs to frame k; its state is converted into
  the port's; both step once on frame k (a keyframe), the port with the
  reference's PnP samples injected. Summaries and states agree: counts and
  masks exactly, the pose within 1e-3, BA costs within rtol 1e-3.
- End to end: both ``run_vo``s replay one 12-frame world, each drawing its
  own PnP samples from the same threefry stream, so the runs are the same
  computation: the keyframe count equal and the keyframe ATE within 1e-4 m
  of the reference's (``test_torch_trajectory.py`` holds every frame).
- Every public name of the JAX package's ``ops``, ``backend``, ``parallel``
  and ``eval`` has a counterpart in the port.
"""

import inspect
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from stereo_vo_tpu.core.camera import CameraInfo as JCameraInfo
from stereo_vo_tpu.core.config import BackendConfig, FrontendConfig, PipelineConfig
from stereo_vo_tpu.data.synthetic import SyntheticStereoSequence
from stereo_vo_tpu.engine import run_vo as jax_run_vo
from stereo_vo_tpu.engine.step import VOEngine as JVOEngine
from stereo_vo_tpu.eval.ate import absolute_trajectory_error

import jax
from stereo_vo_tpu_torch.data.synthetic import SyntheticStereoSequence as TSynthetic
from stereo_vo_tpu_torch.engine.convert import state_from_numpy, state_to_numpy
from stereo_vo_tpu_torch.engine.driver import run_vo
from stereo_vo_tpu_torch.engine.step import SUMMARY_KEYS, VOEngine, parse_summary
from stereo_vo_tpu_torch.frontend.track import track_step
from stereo_vo_tpu_torch.ops.pyramid import build_pyramid

from torch_port_helpers import (
    assert_close,
    assert_equal,
    cpu_engine,
    cpu_run_vo,
    jax_pnp_indices,
    port_camera,
    port_config,
    to_jax,
    to_torch,
)

JCAM = JCameraInfo(focal=400.0, cx=160.0, cy=120.0, baseline=0.5)
SHAPE = (240, 320)
N_FRAMES = 12
STEP_FRAME = 3          # a keyframe of this world in both packages
ATE_TOL = 1e-4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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
def world():
    return SyntheticStereoSequence(cam=JCAM, **_world_kwargs())


@pytest.fixture(scope="module")
def jax_engine():
    return JVOEngine(_config(), SHAPE)


@pytest.fixture(scope="module")
def jax_run(world, jax_engine):
    return jax_run_vo(world, _config(), engine=jax_engine)


@pytest.fixture(scope="module")
def jax_state_at_step(world, jax_engine):
    """The JAX state after frames 0..STEP_FRAME-1."""
    state = jax_engine.init_state()
    for i in range(STEP_FRAME):
        left, right = world.render(i)
        fn = jax_engine.step if bool(state.initialized) else jax_engine.bootstrap
        state, _ = fn(state, to_jax(left), to_jax(right))
    return state


def _kf_ate(poses, gt, stats):
    kf = np.array([s["is_keyframe"] for s in stats])
    return absolute_trajectory_error(poses[kf], gt[kf], align=False)["rmse"], int(kf.sum())


def test_entry_points_default_to_cuda():
    """``VOEngine`` and ``run_vo`` run on the card unless asked for the CPU."""
    assert VOEngine(port_config(_config()), SHAPE).device.type == "cuda"
    assert inspect.signature(run_vo).parameters["device"].default == "cuda"
    assert cpu_engine(port_config(_config()), SHAPE).device.type == "cpu"


def test_state_from_numpy_defaults_to_cuda():
    assert inspect.signature(state_from_numpy).parameters["device"].default == "cuda"


def test_state_round_trip(jax_state_at_step):
    cfg = port_config(_config())
    leaves = [np.asarray(x) for x in jax.tree.leaves(jax_state_at_step)]
    state = state_from_numpy(leaves, cfg, SHAPE, device="cpu")
    back = state_to_numpy(state)
    assert len(back) == len(leaves) == cfg.frontend.lk_max_level + 25
    for i, (a, b) in enumerate(zip(back, leaves)):
        assert a.dtype == b.dtype, i
        assert_equal(a, b, f"leaf {i}")
    with pytest.raises(ValueError):
        state_from_numpy(leaves[:-1], cfg, SHAPE, device="cpu")


def test_step_parity_from_reference_state(world, jax_engine, jax_state_at_step):
    cfg_j = _config()
    cfg_t = port_config(cfg_j)
    left, right = world.render(STEP_FRAME)
    jstate, jout = jax_engine.step(jax_state_at_step, to_jax(left), to_jax(right))
    engine = cpu_engine(cfg_t, SHAPE)
    tstate0 = state_from_numpy([np.asarray(x) for x in jax.tree.leaves(jax_state_at_step)],
                               cfg_t, SHAPE, device="cpu")
    # the reference's PnP samples for this frame: its jax.random draw over the
    # tracked-valid mask (the port's mask; the tracker's parity is asserted
    # below through the counts and the re-initialized slots)
    tracked, _ = track_step(tstate0.tracker, tuple(build_pyramid(to_torch(left), 3)),
                            cfg_t.frontend)
    idx = jax_pnp_indices(tracked.feat_valid.numpy(), STEP_FRAME,
                          cfg_j.frontend.pnp_iterations, cfg_j.frontend.pnp_sample_size)
    tstate, tout = engine.step(tstate0, left, right, pnp_indices=to_torch(idx))

    jpose, jrow = parse_summary(np.asarray(jout.summary))
    tpose, trow = parse_summary(tout.summary)
    assert jrow["is_keyframe"] and trow["is_keyframe"]
    for k in SUMMARY_KEYS:
        if isinstance(jrow[k], (bool, int)):
            assert trow[k] == jrow[k], k
    for k in ("av_parallax", "percent_lost"):
        assert trow[k] == pytest.approx(jrow[k], abs=1e-3), k
    for k in ("ba_initial_cost", "ba_final_cost"):
        assert trow[k] == pytest.approx(jrow[k], rel=1e-3), k
    assert_close(tpose, jpose, atol=1e-3, what="published pose")

    got, want = state_to_numpy(tstate), [np.asarray(x) for x in jax.tree.leaves(jstate)]
    n_pyr = cfg_t.frontend.lk_max_level + 1
    for i, (g, w) in enumerate(zip(got, want)):
        if i < n_pyr:
            assert_close(g, w, atol=1e-3, rtol=1e-6, what=f"pyramid {i}")
        elif np.issubdtype(w.dtype, np.floating):
            assert_close(g, w, atol=2e-3, rtol=1e-3, what=f"leaf {i}")
        else:
            assert_equal(g, w, f"leaf {i}")


def test_end_to_end_ate_matches_reference(world, jax_run):
    cfg = port_config(_config())
    twin = TSynthetic(cam=port_camera(JCAM), **_world_kwargs())
    run = cpu_run_vo(twin, cfg)
    assert len(run.poses) == N_FRAMES and np.all(np.isfinite(run.poses))
    assert all(s["pnp_ok"] for s in run.frame_stats)
    ate, n_kf = _kf_ate(run.poses, world.gt_poses, run.frame_stats)
    ref_ate, ref_kf = _kf_ate(jax_run.poses, world.gt_poses, jax_run.frame_stats)
    assert n_kf == ref_kf >= 4
    assert abs(ate - ref_ate) < ATE_TOL, (ate, ref_ate)
    assert run.ate is not None and run.frames_per_sec > 0


def test_port_sources_import_no_jax():
    """No module of the port imports JAX or the JAX package, on any path."""
    banned = re.compile(r"^\s*(?:import|from)\s+(?:jax|jaxlib|stereo_vo_tpu)(?!\w)", re.M)
    pkg = os.path.join(REPO, "stereo_vo_tpu_torch")
    sources = [os.path.join(d, f) for d, _, files in os.walk(pkg) for f in files
               if f.endswith(".py")]
    assert len(sources) > 20
    offenders = []
    for path in sources + [os.path.join(REPO, f) for f in ("chip_smoke.py", "profile_pair.py")]:
        with open(path) as f:
            offenders += [f"{path}: {m.group(0).strip()}" for m in banned.finditer(f.read())]
    assert not offenders, offenders


def test_port_runs_without_jax(tmp_path):
    """The port's main path, a chunked and checkpointed replay and a resume,
    and the host entry points, in a fresh interpreter that never imports JAX."""
    code = (
        "import sys\n"
        "from stereo_vo_tpu_torch.core.camera import CameraInfo\n"
        "from stereo_vo_tpu_torch.core.config import BackendConfig, FrontendConfig, PipelineConfig\n"
        "from stereo_vo_tpu_torch.data.synthetic import SyntheticStereoSequence\n"
        "from stereo_vo_tpu_torch.engine.driver import run_vo\n"
        "import stereo_vo_tpu_torch.ops, stereo_vo_tpu_torch.eval, stereo_vo_tpu_torch.engine.convert\n"
        "import stereo_vo_tpu_torch.cli, stereo_vo_tpu_torch.smoke, stereo_vo_tpu_torch.data.kitti\n"
        "import stereo_vo_tpu_torch.eval.viz, stereo_vo_tpu_torch.utils.profiling\n"
        "import stereo_vo_tpu_torch.parallel, stereo_vo_tpu_torch.parallel.dryrun\n"
        "import stereo_vo_tpu_torch.eval.cv_twin\n"
        "cam = CameraInfo(focal=200.0, cx=80.0, cy=60.0, baseline=0.4)\n"
        "cfg = PipelineConfig(camera=cam, frontend=FrontendConfig(min_distance=8.0,\n"
        "    parallax_thresh=6.0), backend=BackendConfig(feature_capacity=256,\n"
        "    landmark_capacity=512))\n"
        "w = SyntheticStereoSequence(cam=cam, n_frames=4, shape=(120, 160), n_points=300, seed=2)\n"
        f"run = run_vo(w, cfg, out_dir={str(tmp_path)!r}, device='cpu')\n"
        "assert len(run.poses) == 4\n"
        "frames = list(SyntheticStereoSequence(cam=cam, n_frames=7, shape=(120, 160),\n"
        "    n_points=300, seed=2))\n"
        f"ckpt_dir = {str(tmp_path / 'chunked')!r}\n"
        "run = run_vo(iter(frames), cfg, chunk_size=3, preload_device=True, checkpoint_every=4,\n"
        "    out_dir=ckpt_dir, device='cpu')\n"
        "assert len(run.poses) == 7 and len(run.chunk_seconds) == 2 and run.preload_misses == 0\n"
        "tail = run_vo(iter(frames), cfg, chunk_size=3, resume_from=ckpt_dir + '/checkpoint.npz',\n"
        "    device='cpu')\n"
        "assert [s['frame'] for s in tail.frame_stats] == [4, 5, 6]\n"
        "assert (tail.poses == run.poses[4:]).all()\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "assert not any(m.startswith('stereo_vo_tpu.') or m == 'stereo_vo_tpu' for m in sys.modules)\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path), env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")
    assert (tmp_path / "trajectory_kitti.txt").exists()
    assert (tmp_path / "trajectory_tum.txt").exists()


# JAX names the port gives another name, because what they do differs:
# torch has no global array to assemble, so a rank keeps its own dp block
RENAMED = {"host_local_problem_to_global": "local_dp_block"}


@pytest.mark.parametrize("package", ["ops", "backend", "parallel", "eval"])
def test_public_names_have_port_counterparts(package):
    import importlib

    jax_mod = importlib.import_module(f"stereo_vo_tpu.{package}")
    port_mod = importlib.import_module(f"stereo_vo_tpu_torch.{package}")
    missing = [name for name in jax_mod.__all__
               if RENAMED.get(name, name) not in port_mod.__all__
               or not hasattr(port_mod, RENAMED.get(name, name))]
    assert not missing, f"stereo_vo_tpu_torch.{package} lacks {missing}"
