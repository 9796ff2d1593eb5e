"""Trajectory parity of the port with the JAX package, frame by frame.

The port draws PnP's minimal samples from the reference's own threefry
stream (``frontend/prng.py``), so both packages run the same computation end
to end and each frame of a run can be held to the reference's:

- ``is_keyframe``, ``pnp_ok`` and every other integer field of the summary
  (``eval.parity.INT_KEYS``: detected, tracked, inlier and new-landmark
  counts, BA iterations, the hint flag) are equal;
- the published pose ``[q, t]`` is within ``TRAJ_TOL`` = 1e-4 (quaternion
  units and metres) — 3.52e-6 is the largest difference measured on these
  worlds, f32 rounding in the port's other summation orders;
- the BA costs are within relative ``BA_RTOL`` = 1e-3 (3.5e-5 measured);
- the keyframe ATE is within ``ATE_TOL`` = 1e-4 m of the reference's.

The other shipped geometries, 12 frames of the billboard world at
``kitti03`` (375x1242), ``kitti08`` (370x1226), ``d435i`` (480x640) and
``multisense`` (801x801), are held to their stored JAX runs the same way;
the bundle adjustments of ``d435i`` and ``multisense`` are ill-conditioned
(5 and 7 cm baselines), their references' one-ulp-nudged reruns part from
them at frames 2-3, so they are held by the divergence rule of
``test_torch_long_horizon.py``. The 20-frame world is also run at torch's
default thread count, where the bundle adjustment's Schur Gram sums in
another order, and held by the same rule.

The worlds: the 12-frame 240x320 world of ``test_torch_engine.py`` streamed,
and the 13-frame world of ``test_torch_replay.py`` chunked by 4, both run by
both packages here; and the 20-frame 376x1241 ``kitti00`` world of
``chip_smoke.py`` phase 4, run by the port here and held to the JAX run
stored in ``tests/fixtures/jax_reference/kitti00_w20.npz``
(``tests/fixtures/make_jax_reference.py``). The card's run of phase 4 is held
to the same file by ``chip_smoke.py`` phase 4c, and to ``pnp_draws.npz``
bitwise, as the CPU is here.
"""

import os

import numpy as np
import pytest
import torch

from stereo_vo_tpu.core.camera import CameraInfo as JCameraInfo
from stereo_vo_tpu.core.config import BackendConfig, FrontendConfig, PipelineConfig
from stereo_vo_tpu.data.synthetic import SyntheticStereoSequence
from stereo_vo_tpu.engine import run_vo as jax_run_vo

from stereo_vo_tpu_torch.core.config import load_config
from stereo_vo_tpu_torch.data.synthetic import SyntheticStereoSequence as TSynthetic
from stereo_vo_tpu_torch.eval.ate import absolute_trajectory_error
from stereo_vo_tpu_torch.eval.parity import (
    BA_KEYS,
    INT_KEYS,
    divergence_hold,
    frame_differences,
    run_summaries,
)
from stereo_vo_tpu_torch.frontend.pnp import sample_hypotheses

from torch_port_helpers import DEFAULT_THREADS, cpu_run_vo, port_camera, port_config

TRAJ_TOL = 1e-4
BA_RTOL = 1e-3
ATE_TOL = 1e-4
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                        "jax_reference")
FIXTURE_BYTES = 200_000

JCAM = JCameraInfo(focal=400.0, cx=160.0, cy=120.0, baseline=0.5)
SMALL = {"streamed": (12, 0), "chunked": (13, 4)}      # frames, chunk size


def _small_config():
    return PipelineConfig(
        camera=JCAM,
        frontend=FrontendConfig(min_distance=12.0, parallax_thresh=10.0),
        backend=BackendConfig(feature_capacity=384, landmark_capacity=1024, max_lm_iters=8),
    )


def _small_world(n_frames):
    return dict(n_frames=n_frames, shape=(240, 320), n_points=500, seed=11, speed=0.35,
                yaw_rate=0.004, point_depth=(5.0, 18.0))


def _kf_ate(summaries, gt):
    kf = summaries[:, 7].astype(bool)
    return absolute_trajectory_error(summaries[kf, :7], gt[kf], align=False)["rmse"]


def _hold_frame_by_frame(got, want, what):
    """The module docstring's checks, with the frames and fields that fail."""
    d = frame_differences(got, want)
    for k in INT_KEYS:
        bad = np.nonzero(d[k])[0]
        assert bad.size == 0, f"{what}: {k} differs at frames {bad.tolist()} by {d[k][bad].tolist()}"
    for k in ("dq", "dt"):
        assert d[k].max() <= TRAJ_TOL, (
            f"{what}: pose {k} {d[k].max():.3g} at frame {int(d[k].argmax())} (tol {TRAJ_TOL})")
    for k in BA_KEYS:
        assert d[k].max() <= BA_RTOL, f"{what}: {k} relative {d[k].max():.3g}"
    return d


@pytest.fixture(scope="module", params=sorted(SMALL))
def small_runs(request):
    """Both packages' ``run_vo`` over one small world, each drawing its own
    PnP samples: ``(mode, port summaries, reference summaries, gt)``."""
    n_frames, chunk = SMALL[request.param]
    world = SyntheticStereoSequence(cam=JCAM, **_small_world(n_frames))
    ref = jax_run_vo(world, _small_config(), chunk_size=chunk)
    twin = TSynthetic(cam=port_camera(JCAM), **_small_world(n_frames))
    run = cpu_run_vo(iter(list(twin)), port_config(_small_config()), chunk_size=chunk)
    return request.param, run_summaries(run), run_summaries(ref), world.gt_poses


def test_small_world_frame_by_frame(small_runs):
    mode, got, want, _ = small_runs
    assert got.shape == want.shape == (SMALL[mode][0], 19)
    _hold_frame_by_frame(got, want, mode)
    assert want[:, 7].sum() >= 4                    # keyframes to compare


def test_small_world_keyframe_ate(small_runs):
    mode, got, want, gt = small_runs
    ate, ref_ate = _kf_ate(got, gt), _kf_ate(want, gt)
    assert abs(ate - ref_ate) <= ATE_TOL, (mode, ate, ref_ate)


def _fixture(name):
    return np.load(os.path.join(FIXTURES, name))


def _stored_world(ref):
    """``(config, world)`` of a stored reference run."""
    cfg = load_config(str(ref["config"]))
    world = TSynthetic(cam=cfg.camera, n_frames=int(ref["n_frames"]),
                       shape=tuple(int(s) for s in ref["shape"]),
                       n_points=int(ref["n_points"]), seed=int(ref["seed"]),
                       speed=float(ref["speed"]), yaw_rate=float(ref["yaw_rate"]))
    return cfg, world


@pytest.fixture(scope="module")
def full_size():
    """The port's ``run_vo`` on the CPU over the stored reference's world."""
    ref = _fixture("kitti00_w20.npz")
    cfg, world = _stored_world(ref)
    run = cpu_run_vo(world, cfg, chunk_size=int(ref["chunk_size"]))
    return run_summaries(run), ref["summaries"], world.gt_poses


def test_full_size_world_frame_by_frame(full_size):
    got, want, gt = full_size
    assert got.shape == want.shape == (20, 19)
    _hold_frame_by_frame(got, want, "kitti00, 20 frames, 376x1241")
    assert abs(_kf_ate(got, gt) - _kf_ate(want, gt)) <= ATE_TOL


def test_full_size_world_at_default_threads():
    """The same world at torch's default thread count (the tier-1 workers
    run one thread each), held by the same rule. On this path one reduction
    changes its float32 result with the thread count: the bundle
    adjustment's Schur Gram (``backend/schur.py::_damp_reduce``'s einsum
    over the landmarks, a GEMM whose contraction the BLAS splits among its
    threads); every other stage is bitwise the same at 1 and 8 threads
    (``tests/fixtures/thread_stages.py``)."""
    ref = _fixture("kitti00_w20.npz")
    cfg, world = _stored_world(ref)
    threads = torch.get_num_threads()
    torch.set_num_threads(DEFAULT_THREADS)
    try:
        run = cpu_run_vo(world, cfg, chunk_size=int(ref["chunk_size"]))
    finally:
        torch.set_num_threads(threads)
    got, want = run_summaries(run), ref["summaries"]
    _hold_frame_by_frame(got, want, f"kitti00, 20 frames, {DEFAULT_THREADS} threads")
    assert abs(_kf_ate(got, world.gt_poses) - _kf_ate(want, world.gt_poses)) <= ATE_TOL


# the other shipped geometries: 12 frames of the billboard world streamed at
# each camera's own image size and intrinsics (make_jax_reference.py)
GEOMETRIES = {"kitti03": "kitti03_w12.npz", "d435i": "d435i_w12.npz",
              "kitti08": "kitti08_w12.npz", "multisense": "multisense_w12.npz"}
# phase 5b's and tests/test_torch_long_horizon.py's divergence rule, for a
# world whose reference is not fixed by float32 (its nudged reruns part)
SPREAD_FACTOR = 2.0
ATE_RTOL = 0.10


@pytest.fixture(scope="module", params=sorted(GEOMETRIES))
def geometry_run(request):
    """The port's ``run_vo`` on the CPU over a stored geometry run's world:
    ``(name, port summaries, reference file, gt)``."""
    ref = _fixture(GEOMETRIES[request.param])
    cfg, world = _stored_world(ref)
    run = cpu_run_vo(world, cfg, chunk_size=int(ref["chunk_size"]))
    return request.param, run_summaries(run), ref, world.gt_poses


def test_other_geometry_frame_by_frame(geometry_run):
    """``kitti03`` (375x1242) and ``kitti08`` (370x1226) hold frame by frame;
    ``d435i`` (480x640, a 5 cm baseline) and ``multisense`` (801x801, 7 cm)
    by the divergence rule: their references' own one-ulp-nudged reruns
    part from them at frames 2-3."""
    name, got, ref, gt = geometry_run
    want = ref["summaries"]
    assert got.shape == want.shape == (12, 19) and want[:, 7].sum() >= 10
    if "spread_summaries" not in ref:
        _hold_frame_by_frame(got, want, name)
        assert abs(_kf_ate(got, gt) - _kf_ate(want, gt)) <= ATE_TOL
        return
    report = divergence_hold(got, want, ref["spread_summaries"], gt, TRAJ_TOL, BA_RTOL,
                             SPREAD_FACTOR, ATE_RTOL)
    assert not report["failures"], report
    assert report["reruns_first_departures"] and report["reruns_first_departures"][0] <= 3


def test_fixture_draws_match_sample_hypotheses():
    """The stored reference draws, bitwise, as ``chip_smoke.py`` phase 4c
    holds them on the card."""
    draws = _fixture("pnp_draws.npz")
    idx = draws["indices"].astype(np.int64)
    assert idx.shape[1:] == (99, 6) and len(idx) == len(draws["seeds"]) >= 64
    for valid, seed, want in zip(draws["valid"], draws["seeds"], idx):
        got = sample_hypotheses(torch.from_numpy(valid), idx.shape[1], idx.shape[2], int(seed))
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"seed {seed}")


PHOTO_FIXTURES = ("kitti00_photo_s11_w161_c32.npz", "kitti00_photo_s23_w161_c32.npz")


def test_fixtures_are_small_and_describe_their_worlds():
    files = sorted(os.listdir(FIXTURES))
    assert {"kitti00_w20.npz", "kitti00_w129_c64.npz", "pnp_draws.npz",
            *PHOTO_FIXTURES} <= set(files)
    assert sum(os.path.getsize(os.path.join(FIXTURES, f)) for f in files) < FIXTURE_BYTES
    for name, n_frames, chunk in (("kitti00_w20.npz", 20, 0), ("kitti00_w129_c64.npz", 129, 64),
                                  *((p, 161, 32) for p in PHOTO_FIXTURES)):
        ref = _fixture(name)
        assert int(ref["n_frames"]) == n_frames and int(ref["chunk_size"]) == chunk
        assert ref["summaries"].shape == (n_frames, 19) and np.isfinite(ref["summaries"]).all()
        assert tuple(ref["shape"]) == (376, 1241) and str(ref["config"]) == "kitti00"
        assert str(ref["jax_version"]) and ref["summaries"][:, 7].sum() >= 20
    for name in PHOTO_FIXTURES:
        ref = _fixture(name)
        assert str(ref["texture"]) == "grace_hopper" and int(ref["n_points"]) == 3000
        assert ref["spread_summaries"].shape == (3, 161, 19)
        assert np.isfinite(ref["spread_summaries"]).all()


@pytest.mark.slow
def test_reference_fixture_regenerates(tmp_path):
    """``make_jax_reference.py`` reproduces the committed files: draws
    bitwise, summaries within 1e-6 (relative for the BA costs)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "make_jax_reference", os.path.join(os.path.dirname(FIXTURES), "make_jax_reference.py"))
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    assert gen.main(["--out", str(tmp_path)]) == 0
    for name in sorted(os.listdir(FIXTURES)):
        new, old = np.load(tmp_path / name), _fixture(name)
        if "spread_summaries" in old:
            np.testing.assert_allclose(new["spread_summaries"], old["spread_summaries"],
                                       rtol=1e-6, atol=1e-6, err_msg=name)
        if name == "pnp_draws.npz":
            for k in ("valid", "seeds", "indices"):
                np.testing.assert_array_equal(new[k], old[k], err_msg=k)
            continue
        np.testing.assert_allclose(new["summaries"], old["summaries"], rtol=1e-6, atol=1e-6,
                                   err_msg=name)
