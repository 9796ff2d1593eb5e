"""The plain versions that the bundle adjustment's hand kernels
(``stereo_vo_tpu_torch/csrc/ba_lm.cu``) mirror, held to the JAX package's
functions, and the kernels held to them on the card.

Each case is a window of 5 keyframes built as ``test_torch_backend.py``'s
``_ba_window`` builds one, solved compacted (128 landmark rows) and full
(256): the
landmark-major problem ``bundle_adjust`` hands its LM loop, the same numpy
arrays given to both packages (JAX jitted on the CPU, as
``test_torch_backend.py`` runs it). Tolerances:

- ``_build_system``: every block within rtol 1e-5 of its largest magnitude
  (the two packages round the Jacobians' short sums in other orders; g_l =
  -J^T r sums residuals that cancel), masks equal;
- ``_reduced_system`` (``_damp_reduce`` and the solve's 1e-10 I) from the
  same system: s and rhs within rtol 1e-4 of their largest magnitude (a
  [31, 31] Gram summed over the landmarks in other orders), v_inv within
  rtol 1e-5;
- ``_solve_from_system`` from the same system: poses within 1e-5;
- ``_lm_major_cost`` (the plain ``_lm_major_cost_ref`` on the CPU): rtol
  1e-5;
- one LM body's bookkeeping (``_lm_update``) against the JAX body's from the
  same candidate cost and predicted decrease: lam, nu, rel, done, accepted,
  it and the accept flag equal.

On the CPU every kernel wrapper takes its plain version; the problems that
``bundle_adjust`` hands the loop are ones the kernels take (contiguous, in
their dtypes). The ``cuda`` test holds each kernel on the card against its
plain version on the CPU from the same inputs (``python -m pytest
tests/test_torch_ba_kernels.py -m cuda --noconftest -q``): per-landmark
outputs within 1e-6 of each landmark block's largest magnitude (the step's
block: its position and the products of its back-substitution), summed
ones within 1e-5 of theirs, flags equal, and the whole LM loop's it and
accepted equal with poses within 1e-5.
"""

import dataclasses

import numpy as np
import pytest
import torch

from stereo_vo_tpu_torch.backend import schur as tschur
from stereo_vo_tpu_torch.backend import window as twin
from stereo_vo_tpu_torch.core.camera import CameraInfo
from stereo_vo_tpu_torch.core.config import BackendConfig, PipelineConfig

from torch_port_helpers import assert_close, assert_equal, to_jax, to_numpy, to_torch

TCAM = CameraInfo(focal=400.0, cx=160.0, cy=120.0, baseline=0.5)
CFG_KW = dict(window_size=5, feature_capacity=96, landmark_capacity=256, max_features=80,
              ba_compact_landmarks=128, max_lm_iters=10)


def _jax_camera():
    from stereo_vo_tpu.core.camera import CameraInfo as JCameraInfo

    return JCameraInfo(**dataclasses.asdict(TCAM))


def _jax_config():
    from stereo_vo_tpu.core.config import BackendConfig as JBackendConfig

    return JBackendConfig(**CFG_KW)


def _window(rng, n_lm=100, noise=0.8):
    """A window of 5 keyframes observing ``n_lm`` landmarks with pixel noise,
    perturbed landmarks and poses, stereo priors and a carried damping
    (``test_torch_backend.py::_ba_window``)."""
    w, f, lcap = CFG_KW["window_size"], CFG_KW["feature_capacity"], CFG_KW["landmark_capacity"]
    pts = np.stack([rng.uniform(-6, 6, n_lm), rng.uniform(-2, 2, n_lm),
                    rng.uniform(6, 25, n_lm)], 1)
    poses = np.zeros((w, 7), np.float32)
    poses[:, 0] = 1
    poses[:, 6] = -0.5 * np.arange(w)
    obs_uv = np.zeros((w, f, 2), np.float32)
    obs_lm = np.zeros((w, f), np.int32)
    obs_valid = np.zeros((w, f), bool)
    lm_slots = rng.permutation(lcap)[:n_lm].astype(np.int32)
    for k in range(w):
        seen = rng.permutation(n_lm)[:f]
        seen = seen[rng.random(len(seen)) < 0.85]
        pc = pts[seen] + poses[k, 4:]
        uv = pc[:, :2] / pc[:, 2:3] * TCAM.focal + [TCAM.cx, TCAM.cy]
        obs_uv[k, : len(seen)] = uv + rng.normal(size=uv.shape) * noise
        obs_lm[k, : len(seen)] = lm_slots[seen]
        obs_valid[k, : len(seen)] = True
    lm_pos = np.zeros((lcap, 3), np.float32)
    lm_valid = np.zeros(lcap, bool)
    lm_pos[lm_slots] = pts + rng.normal(size=pts.shape) * 0.2
    lm_valid[lm_slots] = True
    lm_prior = lm_pos + rng.normal(size=lm_pos.shape).astype(np.float32) * 0.05
    lm_prior_w = np.where(lm_valid, rng.uniform(0.5, 5, lcap), 0).astype(np.float32)
    poses[1:, 4:] += rng.normal(size=(w - 1, 3)) * 0.05
    return twin.WindowState(
        poses=to_torch(poses), pose_valid=torch.ones(w, dtype=torch.bool),
        obs_uv=to_torch(obs_uv), obs_lm=to_torch(obs_lm), obs_valid=to_torch(obs_valid),
        lm_pos=to_torch(lm_pos), lm_refcount=to_torch(lm_valid.astype(np.int32)),
        lm_valid=to_torch(lm_valid), lm_prior=to_torch(lm_prior),
        lm_prior_w=to_torch(lm_prior_w), num_kf=torch.tensor(w, dtype=torch.int32),
        ba_lam=torch.tensor(3e-3, dtype=torch.float32))


def _problem(compact, seed=0):
    """``(numpy LandmarkMajorProblem fields, init_lam)`` of the LM loop that
    ``bundle_adjust`` runs on a ``_window`` window, compacted or not."""
    state = _window(np.random.default_rng(seed))
    seen, run = [], tschur._lm_run

    def recording(prob, cam, cfg, init_lam=None, group=None):
        seen.append((prob, init_lam))
        return run(prob, cam, cfg, init_lam, group)

    tschur._lm_run = recording
    try:
        tschur.bundle_adjust(state, TCAM, BackendConfig(**CFG_KW), compact=compact)
    finally:
        tschur._lm_run = run
    (prob, init_lam), = seen
    return [to_numpy(x) for x in prob], to_numpy(init_lam)


def _jax(fn):
    import jax

    return jax.jit(fn)


def _close_blocks(got, want, rtol, what):
    """Each block within ``rtol`` of its largest magnitude."""
    want = np.asarray(want)
    assert_close(got, want, atol=rtol * float(np.abs(want).max()), what=what)


def _systems(prob):
    """The λ-free system at the problem's iterate from both packages:
    ``(port BASystem, JAX BASystem)``."""
    from stereo_vo_tpu.backend import schur as jschur

    jcfg = _jax_config()
    jprob = jschur.LandmarkMajorProblem(*to_jax(prob))
    jcam = _jax_camera()
    jsys = _jax(lambda p: jschur._build_system(p.poses, p.lm_pos, p, jcam, jcfg, None))(jprob)
    tprob = tschur.LandmarkMajorProblem(*to_torch(prob))
    tsys = tschur._build_system(tprob.poses, tprob.lm_pos, tprob, TCAM, BackendConfig(**CFG_KW))
    return tsys, jsys


@pytest.mark.parametrize("compact", [True, False])
def test_build_system_matches_reference(compact):
    prob, _ = _problem(compact)
    assert prob[0].shape == (5, 7) and prob[2].shape[0] == (128 if compact else 256)
    tsys, jsys = _systems(prob)
    for name in ("v", "g_l", "wl", "u_blocks", "g_p"):
        _close_blocks(getattr(tsys, name), getattr(jsys, name), 1e-5, name)
    assert_equal(tsys.lm_active, jsys.lm_active, "lm_active")
    assert_equal(tsys.free, jsys.free, "free")
    assert int(tsys.lm_active.sum()) > 50


@pytest.mark.parametrize("compact", [True, False])
def test_reduced_system_matches_reference(compact):
    from stereo_vo_tpu.backend import schur as jschur

    prob, init_lam = _problem(compact)
    _, jsys = _systems(prob)
    sys_np = [np.asarray(x) for x in jsys]
    lam = np.float32(init_lam)
    js, jrhs, jv_inv, _, _ = _jax(lambda s, l: jschur._damp_reduce(s, l, None))(
        jschur.BASystem(*to_jax(sys_np)), to_jax(lam))
    n = 30
    js = np.asarray(js).reshape(n, n) + np.float32(1e-10) * np.eye(n, dtype=np.float32)
    s_mat, rhs_v, v_inv = tschur._reduced_system(tschur.BASystem(*to_torch(sys_np)),
                                                 to_torch(lam))
    _close_blocks(s_mat, js, 1e-4, "s")
    _close_blocks(rhs_v, np.asarray(jrhs).reshape(n, 1), 1e-4, "rhs")
    _close_blocks(v_inv, jv_inv, 1e-5, "v_inv")


@pytest.mark.parametrize("compact", [True, False])
def test_solve_from_system_matches_reference(compact):
    from stereo_vo_tpu.backend import schur as jschur

    prob, init_lam = _problem(compact)
    _, jsys = _systems(prob)
    sys_np = [np.asarray(x) for x in jsys]
    lam, jcfg, tcfg = np.float32(init_lam), _jax_config(), BackendConfig(**CFG_KW)
    jp, jl, jpred = _jax(lambda s, p, l, lm: jschur._solve_from_system(s, p, l, lm, jcfg, None))(
        jschur.BASystem(*to_jax(sys_np)), to_jax(prob[0]), to_jax(prob[2]), to_jax(lam))
    tp, tl, tpred = tschur._solve_from_system(tschur.BASystem(*to_torch(sys_np)),
                                              to_torch(prob[0]), to_torch(prob[2]),
                                              to_torch(lam), tcfg)
    assert_close(tp, jp, atol=1e-5, what="poses")
    assert not np.array_equal(to_numpy(tp), prob[0]), "the step moved no pose"
    assert_close(tl, jl, atol=1e-3, rtol=1e-4, what="landmarks")
    assert_close(tpred, jpred, atol=0, rtol=1e-3, what="predicted decrease")


@pytest.mark.parametrize("compact", [True, False])
def test_lm_major_cost_matches_reference(compact):
    from stereo_vo_tpu.backend import schur as jschur

    prob, _ = _problem(compact)
    hd, md = CFG_KW.get("huber_delta_px", BackendConfig.huber_delta_px), BackendConfig.min_depth
    jprob = jschur.LandmarkMajorProblem(*to_jax(prob))
    jcam = _jax_camera()
    want = _jax(lambda p: jschur._lm_major_cost(p.poses, p.lm_pos, p, jcam, md, None, hd))(jprob)
    tprob = tschur.LandmarkMajorProblem(*to_torch(prob))
    got = tschur._lm_major_cost_ref(tprob.poses, tprob.lm_pos, tprob, TCAM, md, hd)
    assert_close(got, want, atol=0, rtol=1e-5, what="cost")
    # on the CPU the kernel's wrapper is its plain version
    assert_equal(tschur._lm_major_cost(tprob.poses, tprob.lm_pos, tprob, TCAM, md, hd), got,
                 "ba_cost on the CPU")


# (cost, candidate cost, predicted decrease, lam, nu, rel, done) of one body,
# and config overrides: an accepted step, one under lm_rel_tol, a rejected
# one, a flat reject, a non-finite candidate, saturated damping, a body after
# done
UPDATE_CASES = {
    "accept": ((10.0, 6.0, 5.0, 1e-3, 2.0, 0.5, False), {}),
    "accept_converged": ((10.0, 9.9995, 5e-4, 1e-3, 2.0, 0.5, False), {}),
    "accept_poor_model": ((10.0, 9.0, 20.0, 1e-3, 2.0, 0.5, False), {}),
    "reject": ((10.0, 12.0, 5.0, 1e-3, 4.0, 0.5, False), {}),
    "flat_reject": ((10.0, 10.000001, 5.0, 1e-3, 2.0, 0.5, False), {}),
    "non_finite": ((10.0, float("nan"), 5.0, 1e-3, 2.0, 0.5, False), {}),
    "saturated": ((10.0, 12.0, 5.0, 1e-1, 8.0, 0.5, False), dict(max_damping=1e-1)),
    "after_done": ((10.0, 6.0, 5.0, 1e-3, 2.0, 0.25, True), {}),
}


def _jax_body(jcfg, prob, cand, sys):
    """The JAX ``lm_loop``'s body, with its solve, cost and rebuild giving
    ``cand = (poses, lm_pos, pred, cost)`` and ``sys``: the reference's
    bookkeeping alone."""
    import jax

    from stereo_vo_tpu.backend import schur as jschur

    captured = {}
    while_loop = jax.lax.while_loop

    def capture(cond, body, init):
        captured["body"] = body
        return init

    saved = (jschur._solve_from_system, jschur._lm_major_cost, jschur._build_system)
    jax.lax.while_loop = capture
    try:
        jschur.lm_loop(prob, _jax_camera(), jcfg, None)
    finally:
        jax.lax.while_loop = while_loop
    body2 = captured["body"]
    body = body2.__closure__[body2.__code__.co_freevars.index("body")].cell_contents

    def run(carry):
        jschur._solve_from_system = lambda *_: cand[:3]
        jschur._lm_major_cost = lambda *_, **__: cand[3]
        jschur._build_system = lambda *_: sys
        try:
            return jax.jit(body)(carry)
        finally:
            jschur._solve_from_system, jschur._lm_major_cost, jschur._build_system = saved

    return run


@pytest.mark.parametrize("case", list(UPDATE_CASES))
def test_lm_update_matches_reference_body(case):
    import jax.numpy as jnp

    from stereo_vo_tpu.backend import schur as jschur

    (cost, cand_cost, pred, lam, nu, rel, done), over = UPDATE_CASES[case]
    kw = dict(CFG_KW, **over)
    prob, _ = _problem(True)
    _, jsys = _systems(prob)
    rng = np.random.default_rng(1)
    cand_p = (prob[0] + rng.normal(size=prob[0].shape) * 1e-3).astype(np.float32)
    cand_l = (prob[2] + rng.normal(size=prob[2].shape) * 1e-2).astype(np.float32)
    f32 = np.float32
    carry = (prob[0], prob[2], [np.asarray(x) for x in jsys], f32(lam), f32(nu), f32(cost),
             np.int32(3), np.int32(5), f32(rel), np.bool_(done))
    jcand = (jnp.asarray(cand_p), jnp.asarray(cand_l), jnp.asarray(f32(pred)),
             jnp.asarray(f32(cand_cost)))
    from stereo_vo_tpu.core.config import BackendConfig as JBackendConfig

    jcarry = (*to_jax(carry[:2]), jschur.BASystem(*to_jax(carry[2])), *to_jax(carry[3:]))
    jout = _jax_body(JBackendConfig(**kw), jschur.LandmarkMajorProblem(*to_jax(prob)), jcand,
                     jcarry[2])(jcarry)
    tcarry = tschur._LMCarry(*to_torch(carry[:2]), tschur.BASystem(*to_torch(carry[2])),
                             *[torch.tensor(x) for x in carry[3:]])
    step = tschur._lm_update(tcarry, to_torch(cand_p), to_torch(cand_l),
                             torch.tensor(f32(cand_cost)), torch.tensor(f32(pred)),
                             BackendConfig(**kw))
    # the JAX carry: poses, lm_pos, sys, lam, nu, cost, accepted, it, rel, done
    for name, k in (("poses", 0), ("lm_pos", 1), ("lam", 3), ("nu", 4), ("cost", 5),
                    ("accepted", 6), ("it", 7), ("rel", 8), ("done", 9)):
        assert_equal(getattr(step, name), np.asarray(jout[k]), name)
    assert bool(step.ok) == (int(jout[6]) == 4)


@pytest.mark.parametrize("compact", [True, False])
def test_kernel_wrappers_take_their_inputs(compact):
    """The problem ``bundle_adjust`` hands the LM loop, and a system laid out
    as ``ba_build`` writes it, are what the kernels take; the plain build's
    ``wl`` (a view of its Gram) is not, and the check says so."""
    prob, _ = _problem(compact)
    tprob = tschur.LandmarkMajorProblem(*to_torch(prob))
    cfg = BackendConfig(**CFG_KW)
    cprob = tschur._c_problem(tprob, TCAM, cfg.min_depth, cfg.huber_delta_px)
    assert (cprob.L, cprob.W) == tuple(tprob.obs_valid.shape)
    assert cprob.focal == pytest.approx(TCAM.focal)
    sys = tschur.ba_build(tprob.poses, tprob.lm_pos, tprob, TCAM, cfg)
    with pytest.raises(ValueError, match="wl must be a contiguous"):
        tschur._c_system(sys)
    tschur._c_system(tschur.BASystem(*(t.contiguous() for t in sys)))
    with pytest.raises(ValueError, match="obs_valid"):
        tschur._c_problem(tprob._replace(obs_valid=tprob.obs_valid.to(torch.uint8)), TCAM,
                          cfg.min_depth, cfg.huber_delta_px)


@pytest.mark.cuda
@pytest.mark.parametrize("compact", [True, False])
def test_cuda_ba_kernels_match_plain_versions(compact):
    """``chip_smoke.py`` phase 3e's hold (``_ba_hold``) on this problem: each
    kernel on the card against its plain version on the CPU, and the LM
    loop through the kernels against the loop through the plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import chip_smoke

    dev = torch.device("cuda")
    cfg = PipelineConfig(camera=TCAM, backend=BackendConfig(**CFG_KW))
    prob, init_lam = _problem(compact)
    cprob = tschur.LandmarkMajorProblem(*[to_torch(x).to(dev) for x in prob])
    lam = torch.tensor(init_lam, device=dev)
    got = tschur._lm_run(cprob, TCAM, cfg.backend, lam)
    errs, _ = chip_smoke._ba_hold(torch, cfg, f"compact={compact}", cprob, lam, got, dev)
    assert set(errs) == {"ba_cost", "ba_build", "ba_damp_reduce", "ba_step"}
