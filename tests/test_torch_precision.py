"""Parity of the backend's precision tools with the JAX package: the
condition probe ``reduced_camera_condition`` and the f64 island
(``BackendConfig.reduced_solve_f64``).

The reference honours ``reduced_solve_f64`` only with ``jax_enable_x64`` on
and otherwise silently takes its f32 LU path, so its side of the island's
parity runs under ``jax.enable_x64(True)`` (on the same f32 problem); the
port honours the flag whenever it is set.

Tolerances:
- the condition number: rtol 1e-3 (the same f32 system; singular values
  of its rounding differ);
- LM solves: as ``test_torch_backend.py`` (poses 1e-4, landmarks 1e-3 m with
  rtol 1e-4, costs rtol 1e-4, the same accepted steps), since the normal
  equations are summed in another order.
"""

import jax
import numpy as np
import pytest

from stereo_vo_tpu.backend import schur as jschur
from stereo_vo_tpu.core.camera import CameraInfo as JCameraInfo
from stereo_vo_tpu.core.config import BackendConfig as JBackendConfig

from stereo_vo_tpu_torch.backend import schur as tschur
from stereo_vo_tpu_torch.backend import window as twin
from stereo_vo_tpu_torch.core.config import BackendConfig

from tests.test_schur import make_problem, perturb
from torch_port_helpers import assert_close, port_camera, to_numpy, to_torch

JCAM = JCameraInfo(focal=500.0, cx=320.0, cy=240.0, baseline=0.5)
TCAM = port_camera(JCAM)


def _window(rng, w=4, n_lm=40, l_cap=64, noise_px=0.5):
    jcfg, window_gt, *_ = make_problem(rng, w=w, n_lm=n_lm, f_cap=l_cap, l_cap=l_cap,
                                       noise_px=noise_px)
    return jcfg, perturb(window_gt, rng)


def _port_window(jwindow):
    return twin.WindowState(*[None if x is None else to_torch(x) for x in jwindow])


def _port_problem(jprob):
    return tschur.LandmarkMajorProblem(*[to_torch(x) for x in jprob])


# damped as the solver sees it: undamped, this window's free scale mode puts
# the smallest singular value at f32 rounding level (cond ~4e8), where the
# two packages' rounding decides it
@pytest.mark.parametrize("lam", [1e-4, 1e-2])
def test_condition_probe_matches_reference(rng, lam):
    jcfg, jwindow = _window(rng)
    tcfg = BackendConfig(**jcfg.__dict__)
    jprob = jschur.window_to_landmark_major(jwindow)
    want = float(jschur.reduced_camera_condition(jprob, JCAM, jcfg, lam=lam))
    got = float(tschur.reduced_camera_condition(_port_problem(jprob), TCAM, tcfg, lam=lam))
    assert np.isfinite(want) and want > 1.0
    np.testing.assert_allclose(got, want, rtol=1e-3)


def _jax_lm_loop_x64(jprob, jcfg):
    with jax.enable_x64(True):
        return jax.jit(lambda p: jschur.lm_loop(p, JCAM, jcfg, None))(jprob)


def test_f64_island_matches_reference_lm_loop(rng):
    jcfg, jwindow = _window(rng)
    jcfg = JBackendConfig(**{**jcfg.__dict__, "reduced_solve_f64": True, "max_lm_iters": 10})
    tcfg = BackendConfig(**jcfg.__dict__)
    jprob = jschur.window_to_landmark_major(jwindow)
    want = _jax_lm_loop_x64(jprob, jcfg)
    assert want[0].dtype == np.float32
    got = tschur.lm_loop(_port_problem(jprob), TCAM, tcfg)
    assert int(got[4]) == int(want[4]) > 0
    assert_close(got[2], want[2], atol=0, rtol=1e-5, what="cost0")
    assert_close(got[3], want[3], atol=0, rtol=1e-4, what="cost")
    assert_close(got[0], want[0], atol=1e-4, what="poses")
    lv = np.asarray(jprob.lm_valid)
    assert_close(to_numpy(got[1])[lv], np.asarray(want[1])[lv], atol=1e-3, rtol=1e-4,
                 what="landmarks")
    assert got[0].dtype == got[1].dtype == got[6].dtype == to_torch(np.float32(0)).dtype


def test_bundle_adjust_with_f64_island(rng, monkeypatch):
    """``bundle_adjust`` takes the island (it used to raise): every reduced
    solve is one float64 ``solve_ex`` (the unchecked solve, which a CUDA
    graph can capture), and the result matches the reference's
    ``bundle_adjust`` under x64."""
    import torch

    jcfg, jwindow = _window(rng)
    jcfg = JBackendConfig(**{**jcfg.__dict__, "reduced_solve_f64": True})
    tcfg = BackendConfig(**jcfg.__dict__)
    with jax.enable_x64(True):
        jout, jstats = jax.jit(lambda w: jschur.bundle_adjust(w, JCAM, jcfg))(jwindow)
    solve, dtypes = torch.linalg.solve_ex, []
    monkeypatch.setattr(torch.linalg, "solve_ex",
                        lambda a, b: dtypes.append(a.dtype) or solve(a, b))
    monkeypatch.setattr(torch.linalg, "lu_factor_ex", None)  # the f32 path must not run
    tout, tstats = tschur.bundle_adjust(_port_window(jwindow), TCAM, tcfg)
    assert dtypes and set(dtypes) == {torch.float64}
    assert int(tstats.iterations) == int(jstats.iterations) > 0
    assert float(tstats.final_cost) < 0.5 * float(tstats.initial_cost)
    assert_close(tstats.final_cost, jstats.final_cost, atol=0, rtol=1e-4, what="cost")
    assert_close(tout.poses, jout.poses, atol=1e-4, what="poses")
