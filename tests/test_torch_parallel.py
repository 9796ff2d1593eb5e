"""The landmark-sharded bundle adjuster on ``torch.distributed`` (gloo ranks
on the CPU), held against the port's single-device solver and the JAX
package's ``bundle_adjust``.

Ranks are spawned processes started by the package's own launcher
(``parallel.distributed.spawn_ranks``) from a file store under the test's
temporary directory, each joined with a timeout, so the children import
neither this module, ``conftest.py`` nor JAX, and a hang fails instead of
stalling the suite.

Tolerances are those of the JAX package's ``tests/test_parallel.py``:
initial cost rtol 1e-5, poses rtol 1e-4 + atol 1e-5, live landmarks
rtol 1e-3 + atol 1e-4, final cost rtol 1e-3 + atol 1e-6 (the shards sum
the normal equations in another order than one device does).

The ``cuda``-marked test imports no JAX and runs on a GPU machine with
``python -m pytest tests/test_torch_parallel.py -m cuda --noconftest -q``.
"""

import os

import numpy as np
import pytest
import torch

from stereo_vo_tpu_torch.backend import schur as tschur
from stereo_vo_tpu_torch.backend import window as twin
from stereo_vo_tpu_torch.core.camera import CameraInfo
from stereo_vo_tpu_torch.core.config import BackendConfig
from stereo_vo_tpu_torch.parallel import (
    initialize_multihost,
    local_dp_block,
    make_mesh,
    shard_for_host,
    sharded_lm_solve,
)
from stereo_vo_tpu_torch.parallel.dryrun import (
    dryrun_multichip,
    make_lm_problem,
    solve_on_cpu_ranks,
)

from torch_port_helpers import to_numpy, to_torch

CAM = CameraInfo(focal=500.0, cx=320.0, cy=240.0, baseline=0.5)


def _problem(rng, **kw):
    """``tests/test_schur.py``'s synthetic window, perturbed: the JAX window,
    the port's config and the window as numpy (what the ranks are sent)."""
    from tests.test_schur import make_problem, perturb

    jcfg, window_gt, *_ = make_problem(rng, **kw)
    jwindow = perturb(window_gt, rng)
    np_window = twin.WindowState(*[None if x is None else np.asarray(x) for x in jwindow])
    return jcfg, BackendConfig(**jcfg.__dict__), jwindow, np_window


def _assert_sharded_equal(poses, lm_pos, c0, c1, ref_poses, ref_lm, ref_c0, ref_c1, lm_valid):
    np.testing.assert_allclose(c0, ref_c0, rtol=1e-5)
    np.testing.assert_allclose(poses, ref_poses, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(lm_pos[lm_valid], ref_lm[lm_valid], rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(c1, ref_c1, rtol=1e-3, atol=1e-6)


@pytest.mark.parametrize("n_ranks", [2, 4])
def test_sharded_equals_single_device_and_reference(rng, tmp_path, n_ranks):
    import jax

    from stereo_vo_tpu.backend.schur import bundle_adjust as jax_bundle_adjust
    from stereo_vo_tpu.core.camera import CameraInfo as JCameraInfo

    jcfg, tcfg, jwindow, window = _problem(rng, w=4, n_lm=40, f_cap=64, l_cap=64)
    jout, jstats = jax.jit(lambda w: jax_bundle_adjust(w, JCameraInfo(**CAM.__dict__), jcfg))(
        jwindow)
    tout, tstats = tschur.bundle_adjust(twin.WindowState(*[None if x is None else to_torch(x)
                                                           for x in window]), CAM, tcfg)
    results = solve_on_cpu_ranks(window, CAM, tcfg, n_ranks, store_dir=str(tmp_path))
    lv = window.lm_valid
    for rank_out in results:                       # every rank holds the full result
        np.testing.assert_array_equal(rank_out[0], results[0][0])
        np.testing.assert_array_equal(rank_out[1], results[0][1])
    poses, lm_pos, c0, c1 = results[0]
    _assert_sharded_equal(poses, lm_pos, c0, c1, to_numpy(tout.poses), to_numpy(tout.lm_pos),
                          float(tstats.initial_cost), float(tstats.final_cost), lv)
    _assert_sharded_equal(poses, lm_pos, c0, c1, np.asarray(jout.poses), np.asarray(jout.lm_pos),
                          float(jstats.initial_cost), float(jstats.final_cost), lv)
    assert float(c1) < 0.5 * float(c0)


def test_dp_batch_equals_per_window_solves(rng, tmp_path):
    """dp 2 x lm 2: each window of the batch equals its own single-device
    solve in the port and the JAX package's ``lm_loop``."""
    import jax

    from stereo_vo_tpu.backend import schur as jschur
    from stereo_vo_tpu.core.camera import CameraInfo as JCameraInfo

    jcfg, tcfg, jw0, w0 = _problem(rng, w=3, n_lm=16, f_cap=32, l_cap=32)
    _, _, jw1, w1 = _problem(rng, w=3, n_lm=16, f_cap=32, l_cap=32)
    probs = [tschur.window_to_landmark_major(twin.WindowState(
        *[None if x is None else to_torch(x) for x in w])) for w in (w0, w1)]
    batch = tschur.LandmarkMajorProblem(*[np.stack([to_numpy(p[i]) for p in probs])
                                          for i in range(len(probs[0]))])
    results = solve_on_cpu_ranks(batch, CAM, tcfg, 4, dp=2, store_dir=str(tmp_path))
    poses_b, lm_b, c0_b, c1_b = results[0]
    assert poses_b.shape == (2, 3, 7) and lm_b.shape == (2, 32, 3) and c1_b.shape == (2,)
    for r in results[1:]:
        np.testing.assert_array_equal(r[0], poses_b)
    jax_solve = jax.jit(lambda p: jschur.lm_loop(p, JCameraInfo(**CAM.__dict__), jcfg, None))
    for i, (prob, jw) in enumerate(zip(probs, (jw0, jw1))):
        lv = to_numpy(prob.lm_valid)
        poses, lm_pos, c0, c1, *_ = tschur.lm_loop(prob, CAM, tcfg)
        _assert_sharded_equal(poses_b[i], lm_b[i], c0_b[i], c1_b[i], to_numpy(poses),
                              to_numpy(lm_pos), float(c0), float(c1), lv)
        jposes, jlm, jc0, jc1, *_ = jax_solve(jschur.window_to_landmark_major(jw))
        _assert_sharded_equal(poses_b[i], lm_b[i], c0_b[i], c1_b[i], np.asarray(jposes),
                              np.asarray(jlm), float(jc0), float(jc1), lv)


def test_indivisible_capacity_raises(rng, tmp_path):
    _, tcfg, _, window = _problem(rng, w=3, n_lm=10, f_cap=16, l_cap=18)
    with pytest.raises(torch.multiprocessing.ProcessRaisedException, match="not divisible"):
        solve_on_cpu_ranks(window, CAM, tcfg, 4, store_dir=str(tmp_path), timeout=60)


def test_multihost_helpers_single_process(monkeypatch):
    for var in ("SVO_COORDINATOR", "SVO_NUM_PROCESSES", "SVO_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    assert initialize_multihost() == (0, 1)          # nothing requested: no-op
    assert shard_for_host(list(range(7))) == list(range(7))
    items = list(range(11))
    parts = [shard_for_host(items, i, 3) for i in range(3)]
    assert sum(parts, []) == items
    assert [len(p) for p in parts] == [4, 4, 3]
    with pytest.raises(RuntimeError, match="initialized process group"):
        make_mesh((1,), device_type="cpu")


def test_multihost_world_from_environment(tmp_path, monkeypatch):
    """``initialize_multihost`` from the ``SVO_*`` variables (a world of one
    gloo rank here), then the refusals: a mesh larger than the world, a solve
    without a world, and tensors on another device than the mesh's."""
    import torch.distributed as dist

    class CudaMesh:                    # this rank in a mesh of cuda devices
        device_type = "cuda"

        def get_coordinate(self):
            return [0]

    prob = tschur.LandmarkMajorProblem(*[to_torch(x) for x in make_lm_problem(2, 8, CAM)])
    with pytest.raises(RuntimeError, match="initialized process group"):
        sharded_lm_solve(prob, CAM, BackendConfig(window_size=2, landmark_capacity=8), CudaMesh())
    monkeypatch.setenv("SVO_COORDINATOR", f"file://{tmp_path / 'store'}")
    monkeypatch.setenv("SVO_NUM_PROCESSES", "1")
    monkeypatch.setenv("SVO_PROCESS_ID", "0")
    try:
        assert initialize_multihost() == (0, 1)
        assert dist.get_backend() == "gloo"            # no CUDA here
        assert make_mesh(device_type="cpu").size() == 1
        with pytest.raises(ValueError, match="needs 2 ranks"):
            make_mesh((2,), device_type="cpu")
        with pytest.raises(ValueError, match="mesh on 'cuda'"):
            sharded_lm_solve(prob, CAM, BackendConfig(window_size=2, landmark_capacity=8),
                             CudaMesh())
    finally:
        dist.destroy_process_group()


def test_local_dp_block_is_this_ranks_share():
    class Mesh:                        # a dp axis of 2, this rank second on it
        mesh_dim_names = ("dp", "lm")

        def size(self, dim):
            return (2, 2)[dim]

        def get_local_rank(self, axis):
            return 1

    batch = {"a": np.arange(8, dtype=np.float32).reshape(4, 2), "b": (torch.arange(4),)}
    block = local_dp_block(batch, Mesh())
    np.testing.assert_array_equal(block["a"], [[4, 5], [6, 7]])
    assert block["b"][0].tolist() == [2, 3]
    with pytest.raises(ValueError, match="not divisible"):
        local_dp_block({"a": np.zeros((3, 1))}, Mesh())


def test_dryrun_multichip_on_cpu(tmp_path, capfd):
    summary = dryrun_multichip(4, "cpu", shapes=(("small_5x256", 5, 256),), timeout=120,
                               store_dir=str(tmp_path))
    assert summary["tiny_batch"]["dp"] == 2 and summary["tiny_batch"]["lm"] == 2
    row = summary["shapes"]["small_5x256"]
    assert sorted(row["shards"]) == [1, 2, 4]
    assert all(s["iters_per_s"] > 0 for s in row["shards"].values())
    assert row["comm_bytes"]["per_attempt"] == (31 * 31 + 2) * 4
    assert "all-reduce bytes per damping attempt" in capfd.readouterr().out


@pytest.mark.cuda
def test_one_rank_nccl_sharded_solve(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import torch.distributed as dist

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    cam = CameraInfo(focal=718.856, cx=607.19, cy=185.22, baseline=0.537)
    cfg = BackendConfig(window_size=5, landmark_capacity=2048, max_lm_iters=4, lm_rel_tol=0.0)
    prob = tschur.LandmarkMajorProblem(*[torch.as_tensor(x).to(dev)
                                         for x in make_lm_problem(5, 2048, cam)])
    ref = tschur.lm_loop(prob, cam, cfg)
    dist.init_process_group("nccl", init_method=f"file://{os.path.join(tmp_path, 'store')}",
                            world_size=1, rank=0)
    try:
        poses, lm_pos, c0, c1 = sharded_lm_solve(prob, cam, cfg, make_mesh((1,), ("lm",), "cuda"))
    finally:
        dist.destroy_process_group()
    assert float((poses - ref[0]).abs().max()) <= 2e-4
    assert float((lm_pos - ref[1]).abs().max()) <= 2e-3
    assert float(c1) < float(c0)
