"""The port's step without host reads but its decisions, and its CUDA graph.

On the CPU:
- a ``TorchDispatchMode`` counts the operators that read a device value back
  to the host (``_local_scalar_dense``, behind ``int()``, ``bool()`` and
  ``.item()``; ``nonzero``; indexing and ``index_put`` with a boolean mask;
  ``masked_select``; the error checks of ``torch.linalg``). ``lm_loop``
  and each ``bundle_adjust`` solve past its compaction choice read nothing
  but the predicates of their loop and of its rebuilds (``engine/graphs.py``:
  ``while_loop`` reads one per trip and one to stop, ``cond`` one, two
  rebuilds a trip: ``3 * ceil(it / 2) + 1`` a solve), and ``pnp_ransac``
  and ``add_keyframe`` read nothing, at the defaults' full sizes (window 5,
  448 feature slots, 2048 landmarks, 100 PnP hypotheses); the engine's
  keyframe work reads nothing but the plain versions of the hand kernels
  and the solves' predicates; the whole ``VOEngine.step`` (the gate closed,
  a keyframe, a hinted frame) and ``track_step`` read each ``cond``'s
  predicate once (six conds a step, two in the tracker, on the CPU) and the
  solve's loop and rebuild predicates, and nothing else but the plain
  kernels;
- the LM loop against the JAX ``lm_loop`` on the same numpy problems, at
  each of its stops (the relative decrease under ``lm_rel_tol``, a flat
  reject, saturated damping, the iteration limit at odd ``max_lm_iters`` 7
  and 9): the same number of updating iterations (the reference's ``it``,
  read from its ``while_loop``) and of accepted steps, the same damping,
  costs within the backend tolerance of ``tests/test_torch_backend.py``
  (rtol 1e-5 initial, 1e-4 final; poses 1e-4, landmarks 1e-3 m); bitwise
  the masked fixed trip of ``lm_trip(max_lm_iters)`` bodies that rebuilds
  every body (kept here as the oracle), at the same stops and on the full
  windows; and one ``_build_system`` call per accepted step and one more;
- ``detect_corners`` (its plain NMS) bitwise the jitted JAX function on a
  real frame and frame 0 of the photo and billboard worlds at 376x1241.

The ``cuda`` tests need the card (``python -m pytest
tests/test_torch_sync_free.py -m cuda --noconftest -q``): ``greedy_nms``
(``csrc/greedy_nms.cu``) bitwise its plain versions, the accepted set and
the capped pack, on frames 0-4 of the 20-frame world, a photo frame, 1024
valid candidates in one conflict chain, none valid, candidates at the image
corners, seeded pools of 1025 to 4096 candidates and the binning's edges
(``torch_port_helpers.nms_pool``), one launch per call; and
the steps replayed from the step's CUDA graph bitwise the eager ones. JAX is
imported inside the CPU tests only.
"""

import os

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from stereo_vo_tpu_torch.backend import schur as tschur
from stereo_vo_tpu_torch.backend import window as twin
from stereo_vo_tpu_torch.core.camera import CameraInfo
from stereo_vo_tpu_torch.core.config import BackendConfig, FrontendConfig, load_config
from stereo_vo_tpu_torch.frontend.pnp import pnp_ransac
from stereo_vo_tpu_torch.ops import shi_tomasi as tst

from torch_port_helpers import assert_close, assert_equal, to_torch

aten = torch.ops.aten
KITTI_CAM = CameraInfo(focal=718.856, cx=607.1928, cy=185.2157, baseline=0.537)
SMALL_CAM = CameraInfo(focal=300.0, cx=160.0, cy=120.0, baseline=0.3)
REAL = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "real")


class HostReads(TorchDispatchMode):
    """Counts the operators that read a tensor's value back to the host."""

    ALWAYS = {aten._local_scalar_dense.default, aten.nonzero.default,
              aten.masked_select.default, aten._linalg_check_errors.default}
    MASKED = {aten.index.Tensor, aten.index_put.default, aten.index_put_.default,
              aten._index_put_impl_.default}

    def __init__(self):
        super().__init__()
        self.reads = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in self.ALWAYS:
            self.reads.append(str(func))
        elif func in self.MASKED and any(
                isinstance(i, torch.Tensor) and i.dtype in (torch.bool, torch.uint8)
                for i in args[1]):
            self.reads.append(f"{func} with a boolean mask")
        return func(*args, **kwargs)


@pytest.mark.parametrize("read", ["int", "bool", "item", "nonzero", "mask_index", "mask_put"])
def test_host_read_counter_sees_each_read(read):
    x = torch.arange(6.0)
    fns = {"int": lambda: int(x.sum()), "bool": lambda: bool(x.any()),
           "item": lambda: x[2].item(), "nonzero": lambda: torch.nonzero(x),
           "mask_index": lambda: x[x > 2], "mask_put": lambda: x.clone().index_put_((x > 2,),
                                                                                    x[:3])}
    with HostReads() as counter:
        fns[read]()
    assert len(counter.reads) >= 1, read
    with HostReads() as counter:
        torch.where(x > 2, x, 0.0).sum() + x[torch.tensor([1, 3])]
    assert counter.reads == []


def _full_window(seed, n_lm, cfg=BackendConfig()):
    """A window at the defaults' capacities (5 keyframes, 448 slots, 2048
    landmarks) observing ``n_lm`` landmarks at scattered ids, with pixel
    noise, perturbed landmarks and poses, stereo priors and a carried
    damping."""
    rng = np.random.default_rng(seed)
    w, f, lcap = cfg.window_size, cfg.feature_capacity, cfg.landmark_capacity
    pts = np.stack([rng.uniform(-15, 15, n_lm), rng.uniform(-3, 3, n_lm),
                    rng.uniform(8, 60, n_lm)], 1)
    poses = np.zeros((w, 7), np.float32)
    poses[:, 0] = 1
    poses[:, 6] = -0.8 * np.arange(w)
    obs_uv = np.zeros((w, f, 2), np.float32)
    obs_lm = np.zeros((w, f), np.int32)
    obs_valid = np.zeros((w, f), bool)
    lm_slots = rng.permutation(lcap)[:n_lm].astype(np.int32)
    for k in range(w):
        seen = rng.permutation(n_lm)[:f]
        seen = seen[rng.random(len(seen)) < 0.9]
        pc = pts[seen] + poses[k, 4:]
        uv = pc[:, :2] / pc[:, 2:3] * KITTI_CAM.focal + [KITTI_CAM.cx, KITTI_CAM.cy]
        obs_uv[k, : len(seen)] = uv + rng.normal(size=uv.shape) * 0.7
        obs_lm[k, : len(seen)] = lm_slots[seen]
        obs_valid[k, : len(seen)] = True
    lm_pos = np.zeros((lcap, 3), np.float32)
    lm_valid = np.zeros(lcap, bool)
    lm_pos[lm_slots] = pts + rng.normal(size=pts.shape) * 0.3
    lm_valid[lm_slots] = True
    refcount = np.zeros(lcap, np.int32)
    np.add.at(refcount, obs_lm[obs_valid], 1)
    lm_valid &= refcount > 0
    lm_prior = lm_pos + rng.normal(size=lm_pos.shape).astype(np.float32) * 0.1
    lm_prior_w = np.where(lm_valid, rng.uniform(0.5, 5, lcap), 0).astype(np.float32)
    poses[1:, 4:] += rng.normal(size=(w - 1, 3)) * 0.05
    return twin.WindowState(*to_torch([
        poses, np.ones(w, bool), obs_uv, obs_lm, obs_valid, lm_pos, refcount, lm_valid,
        lm_prior, lm_prior_w, np.int32(w), np.float32(1e-3)]))


@pytest.fixture(scope="module")
def small_window():
    """Live landmarks under ``ba_compact_landmarks`` (512): the compacted solve."""
    return _full_window(0, 420)


@pytest.fixture(scope="module")
def large_window():
    """Live landmarks over 512: the full-capacity solve."""
    return _full_window(1, 1500)


def _loop_reads(its) -> int:
    """The predicates the LM loops that updated ``its`` bodies read on the
    CPU: one per trip of pairs and one to stop, and one per body's rebuild
    choice."""
    return sum(3 * ((int(it) + 1) // 2) + 1 for it in its)


def _recorded_its(monkeypatch) -> list:
    """Each LM loop's ``it`` (bodies that updated) as it returns, a tensor:
    reading it here would be a host read."""
    its, run = [], tschur._lm_run

    def recording(*args, **kwargs):
        out = run(*args, **kwargs)
        its.append(out[7])
        return out

    monkeypatch.setattr(tschur, "_lm_run", recording)
    return its


def test_lm_loop_reads_nothing(large_window, monkeypatch):
    """Nothing but the loop's and the rebuilds' predicates."""
    from stereo_vo_tpu_torch.engine import graphs

    cfg = BackendConfig()
    its = _recorded_its(monkeypatch)
    reads = graphs._ctx.reads
    with HostReads() as counter:
        prob = tschur.window_to_landmark_major(large_window)
        out = tschur.lm_loop(prob, KITTI_CAM, cfg, init_lam=large_window.ba_lam)
    preds = graphs._ctx.reads - reads
    assert len(its) == 1 and preds == _loop_reads(its)
    assert counter.reads == ["aten._local_scalar_dense.default"] * preds
    assert float(out[3]) < 0.5 * float(out[2]) and int(out[4]) > 0


@pytest.mark.parametrize("compact", [True, False])
def test_bundle_adjust_solve_reads_nothing(small_window, large_window, compact, monkeypatch):
    """Nothing but the loop's and the rebuilds' predicates (and, without
    ``compact``, the compaction choice)."""
    from stereo_vo_tpu_torch.engine import graphs

    cfg = BackendConfig()
    window = small_window if compact else large_window
    assert (int(window.lm_valid.sum()) <= cfg.ba_compact_landmarks) == compact
    its = _recorded_its(monkeypatch)
    reads = graphs._ctx.reads
    with HostReads() as counter:
        out, stats = tschur.bundle_adjust(window, KITTI_CAM, cfg, compact=compact)
    preds = graphs._ctx.reads - reads
    assert preds == _loop_reads(its) and len(counter.reads) == preds
    # the solve the choice reads its way to is the same solve
    reads = graphs._ctx.reads
    with HostReads() as counter:
        chosen, chosen_stats = tschur.bundle_adjust(window, KITTI_CAM, cfg)
    assert graphs._ctx.reads - reads == preds and len(counter.reads) == 1 + preds
    assert_equal(chosen.poses, out.poses, "poses")
    assert_equal(chosen_stats.final_cost, stats.final_cost, "cost")
    assert float(stats.final_cost) < float(stats.initial_cost)


@pytest.mark.parametrize("full", [True, False])
def test_add_keyframe_reads_nothing(large_window, full):
    cfg = BackendConfig()
    rng = np.random.default_rng(3)
    f = cfg.feature_capacity
    window = large_window if full else large_window._replace(
        num_kf=torch.tensor(3, dtype=torch.int32),
        pose_valid=torch.tensor([True, True, True, False, False]))
    live = np.nonzero(window.lm_valid.numpy())[0]
    tracked_lm = rng.permutation(live)[:f].astype(np.int32)
    tracked_prior_pos = (rng.normal(size=(f, 3)) + [0, 0, 20]).astype(np.float32)
    tracked_prior_pos[5] = np.inf
    args = to_torch([np.array([1, 0, 0, 0, 0.1, 0, 0.9], np.float32),
                     rng.uniform(0, 1241, (f, 2)).astype(np.float32), tracked_lm,
                     rng.random(f) < 0.6, rng.uniform(0, 1241, (f, 2)).astype(np.float32),
                     (rng.normal(size=(f, 3)) + [0, 0, 20]).astype(np.float32),
                     rng.random(f) < 0.7, rng.uniform(0.1, 5, f).astype(np.float32),
                     tracked_prior_pos,
                     np.where(rng.random(f) < 0.5, rng.uniform(0.1, 3, f), 0).astype(np.float32)])
    args[3][5] = False                       # the slot holding inf is masked
    with HostReads() as counter:
        out, new_ids, new_valid = twin.add_keyframe(window, cfg, *args)
    assert counter.reads == []
    assert int(out.num_kf) == int(window.num_kf) + 1 and int(new_valid.sum()) > 0
    assert bool(torch.isfinite(out.lm_prior).all()) and bool(torch.isfinite(out.lm_pos).all())
    assert int(out.pose_valid.sum()) == (5 if full else 4)


def test_pnp_ransac_reads_nothing():
    fc = FrontendConfig()
    rng = np.random.default_rng(5)
    f = BackendConfig().feature_capacity
    pts = np.stack([rng.uniform(-15, 15, f), rng.uniform(-3, 3, f),
                    rng.uniform(8, 60, f)], 1).astype(np.float32)
    pose = np.array([0.9998, 0.01, -0.015, 0.005, 0.2, -0.05, -0.8], np.float32)
    pose[:4] /= np.linalg.norm(pose[:4])
    from stereo_vo_tpu_torch.core.geometry import pose_apply

    pc = pose_apply(torch.from_numpy(pose)[None], torch.from_numpy(pts)).numpy()
    uv = pc[:, :2] / pc[:, 2:3] * KITTI_CAM.focal + [KITTI_CAM.cx, KITTI_CAM.cy]
    uv += rng.normal(size=uv.shape) * 0.5
    uv[rng.random(f) < 0.15] += 40.0                              # outliers
    valid = rng.random(f) < 0.7
    prev = np.array([1, 0, 0, 0, 0.15, 0, -0.7], np.float32)
    args = to_torch([pts, uv.astype(np.float32), valid, prev])
    with HostReads() as counter:
        res = pnp_ransac(args[0], args[1], args[2], KITTI_CAM, args[3],
                         torch.tensor(17, dtype=torch.int32), fc)
    assert counter.reads == []
    assert bool(res.ok) and int(res.num_inliers) > 0.5 * valid.sum()
    # the frame index as a tensor seeds the same draw as the Python int
    same = pnp_ransac(args[0], args[1], args[2], KITTI_CAM, args[3], 17, fc)
    assert_equal(res.pose, same.pose, "pose")
    assert_equal(res.inliers, same.inliers, "inliers")


def test_keyframe_stretches_read_nothing_but_the_plain_kernels(monkeypatch):
    """The engine's keyframe work (PnP, the work up to the solve and each
    solve, the bodies of the step's conds) on the CPU, on a keyframe of a
    240x320 world: the only reads are the plain versions' of the hand
    kernels, the greedy NMS's (one per round and one more) and sparse BM's
    compaction choice (the card's kernels make none), and the predicates of
    each solve's LM loop and rebuilds (a WHILE node and IF pairs on the
    card)."""
    from stereo_vo_tpu_torch.engine import graphs
    from stereo_vo_tpu_torch.core.config import PipelineConfig
    from stereo_vo_tpu_torch.data.synthetic import SyntheticStereoSequence
    from stereo_vo_tpu_torch.engine.step import VOEngine
    from stereo_vo_tpu_torch.frontend.track import track_step
    from stereo_vo_tpu_torch.ops import stereo_bm

    cfg = PipelineConfig(camera=SMALL_CAM,
                         frontend=FrontendConfig(min_distance=12.0, parallax_thresh=10.0),
                         backend=BackendConfig(feature_capacity=384, landmark_capacity=1024,
                                               max_lm_iters=8))
    world = SyntheticStereoSequence(cam=SMALL_CAM, n_frames=3, shape=(240, 320), n_points=500,
                                    seed=11, speed=0.35, yaw_rate=0.004, point_depth=(5.0, 18.0))
    engine = VOEngine(cfg, (240, 320), device="cpu")
    assert not engine.graphs
    with pytest.raises(ValueError):
        VOEngine(cfg, (240, 320), device="cpu", graphs=True)
    state, _ = engine.bootstrap(engine.init_state(), *world.render(0))
    state, _ = engine.step(state, *world.render(1))
    left, right = (torch.from_numpy(a).to(torch.float32) for a in world.render(2))
    pyr, _, resp = engine._preprocess(left)
    tracked, _ = track_step(state.tracker, tuple(pyr), cfg.frontend)

    plain_reads = {}

    def counted(module, name):
        plain = getattr(module, name)

        def run(*args, **kwargs):
            before = len(counter.reads)
            out = plain(*args, **kwargs)
            plain_reads[name] = plain_reads.get(name, 0) + len(counter.reads) - before
            return out

        monkeypatch.setattr(module, name, run)

    counted(tst, "greedy_nms_ref")
    counted(stereo_bm, "stereo_bm_at_ref")
    its = _recorded_its(monkeypatch)
    reads = graphs._ctx.reads
    with HostReads() as counter:
        res = engine._pnp(state.window.lm_pos, tracked.feat_ids, tracked.feat_xy,
                          tracked.feat_valid, state.pnp_pose, state.frame_idx)
        prep = engine._keyframe_prep(left, right, res.pose, res.inliers, tracked.feat_xy,
                                     tracked.feat_ids, tracked.feat_valid, state.window, resp)
        window, det_xy, inlier_valid, new_ids, new_valid, live = prep
        outs = [engine._keyframe_solve(compact, window, det_xy, inlier_valid, new_ids,
                                       new_valid, tracked.feat_xy, tracked.feat_ids,
                                       tracked.flow_xy, tracked.flow_valid)
                for compact in (True, False)]
    preds = graphs._ctx.reads - reads
    assert plain_reads["greedy_nms_ref"] >= 2 and plain_reads["stereo_bm_at_ref"] == 1
    assert len(its) == 2 and preds == _loop_reads(its)
    assert len(counter.reads) == sum(plain_reads.values()) + preds, counter.reads
    assert bool(res.ok) and int(live) > 0
    for out in outs:
        assert int(out[3][2]) > 0                            # accepted LM steps


def _plain_read_counter(monkeypatch, counter_box):
    """Count the host reads that the plain versions of the hand kernels
    make (the card's kernels make none), by name."""
    from stereo_vo_tpu_torch.ops import lk, stereo_bm

    plain_reads = {}

    def counted(module, name):
        plain = getattr(module, name)

        def run(*args, **kwargs):
            before = len(counter_box[0].reads)
            out = plain(*args, **kwargs)
            plain_reads[name] = plain_reads.get(name, 0) + len(counter_box[0].reads) - before
            return out

        monkeypatch.setattr(module, name, run)

    counted(tst, "greedy_nms_ref")
    counted(stereo_bm, "stereo_bm_at_ref")
    counted(lk, "lk_level_pass_ref")
    return plain_reads


@pytest.fixture(scope="module")
def small_world_states():
    """The port on the 240x320 world of ``test_torch_engine.py``: its state
    before frames 2 (the gate closed), 3 (a keyframe) and 4 (hinted)."""
    from stereo_vo_tpu_torch.core.config import PipelineConfig
    from stereo_vo_tpu_torch.data.synthetic import SyntheticStereoSequence
    from stereo_vo_tpu_torch.engine.step import VOEngine

    cfg = PipelineConfig(camera=SMALL_CAM,
                         frontend=FrontendConfig(min_distance=12.0, parallax_thresh=10.0),
                         backend=BackendConfig(feature_capacity=384, landmark_capacity=1024,
                                               max_lm_iters=8))
    world = SyntheticStereoSequence(cam=SMALL_CAM, n_frames=5, shape=(240, 320), n_points=500,
                                    seed=11, speed=0.35, yaw_rate=0.004, point_depth=(5.0, 18.0))
    engine = VOEngine(cfg, (240, 320), device="cpu")
    frames = [world.render(i) for i in range(5)]
    state, _ = engine.bootstrap(engine.init_state(), *frames[0])
    states = {}
    for i in range(1, 5):
        states[i] = state
        state, _ = engine.step(state, *frames[i])
    return cfg, engine, frames, states


# the step's conds on the CPU: the tracker's live-slot compaction and its
# hinted choice, PnP, the keyframe work and the two solves (a keyframe's
# solve adds its LM loop's and rebuilds' predicates, ``_loop_reads``)
STEP_CONDS = 6
TRACK_CONDS = 2


@pytest.mark.parametrize("frame", [2, 3, 4])
def test_step_reads_one_predicate_per_cond(small_world_states, monkeypatch, frame):
    """``VOEngine.step`` on the CPU reads each cond's predicate once, and a
    keyframe's solve its loop's and rebuilds' predicates, and nothing else
    but the plain versions of the hand kernels."""
    from stereo_vo_tpu_torch.engine import graphs
    from stereo_vo_tpu_torch.engine.step import parse_summary

    _, engine, frames, states = small_world_states
    box = [None]
    plain_reads = _plain_read_counter(monkeypatch, box)
    its = _recorded_its(monkeypatch)
    reads = graphs._ctx.reads
    with HostReads() as counter:
        box[0] = counter
        _, out = engine.step(states[frame], *frames[frame])
    preds = graphs._ctx.reads - reads
    assert len(its) == (frame == 3)
    assert preds == STEP_CONDS + _loop_reads(its)
    assert len(counter.reads) == sum(plain_reads.values()) + preds, counter.reads
    row = parse_summary(out.summary)[1]
    assert row["is_keyframe"] == (frame == 3) and row["hinted"] == (frame != 2)


def test_track_step_reads_one_predicate_per_cond(small_world_states, monkeypatch):
    from stereo_vo_tpu_torch.engine import graphs
    from stereo_vo_tpu_torch.frontend.track import track_step

    cfg, engine, frames, states = small_world_states
    left = torch.from_numpy(frames[4][0]).to(torch.float32)
    pyr = engine._preprocess(left)[0]
    box = [None]
    plain_reads = _plain_read_counter(monkeypatch, box)
    reads = graphs._ctx.reads
    with HostReads() as counter:
        box[0] = counter
        _, stats = track_step(states[4].tracker, pyr, cfg.frontend)
    conds = graphs._ctx.reads - reads
    assert conds == TRACK_CONDS and plain_reads["lk_level_pass_ref"] > 0
    assert len(counter.reads) == plain_reads["lk_level_pass_ref"] + conds, counter.reads
    assert bool(stats.hinted)


# ---------------------------------------------------------------------------
# the LM loop against the reference's while_loop

def _lm_problem(seed, lm_jitter, pose_jitter, nan_obs=False, flat=False):
    """A 3-pose, 64-landmark problem (``parallel/dryrun.py::make_lm_problem``)
    with perturbed landmarks and poses and stereo priors; ``nan_obs`` puts a
    NaN into one observation, so every step is rejected; ``flat`` drops
    every observation and puts each landmark at its prior, so no step can
    change the cost."""
    from stereo_vo_tpu_torch.parallel.dryrun import make_lm_problem

    p = make_lm_problem(3, 64, SMALL_CAM, noise=0.5, seed=seed)
    rng = np.random.default_rng(seed + 100)
    lm = (p.lm_pos + rng.normal(size=p.lm_pos.shape) * lm_jitter).astype(np.float32)
    poses = p.poses.copy()
    poses[:, 4:] += (rng.normal(size=(3, 3)) * pose_jitter).astype(np.float32)
    p = p._replace(lm_pos=lm, poses=poses, lm_prior_w=np.full(64, 0.5, np.float32))
    if nan_obs:
        obs = p.obs_uv.copy()
        obs[5, 1, 0] = np.nan
        p = p._replace(obs_uv=obs)
    if flat:
        p = p._replace(obs_valid=np.zeros_like(p.obs_valid), lm_prior=p.lm_pos.copy())
    return p


# (stop, problem, config): the relative-decrease stop after 3 accepted steps;
# a flat reject (no observation, landmarks at their priors); saturated
# damping (every step rejected: lam doubles its doubling until max_damping);
# the iteration limit at odd max_lm_iters, a heavy damping keeping every
# step accepted well above lm_rel_tol (8 and 10 iterations: pairs)
LM_CASES = {
    "rel_tol": (dict(lm_jitter=0.05, pose_jitter=0.02), {}),
    "flat_reject": (dict(lm_jitter=0.0, pose_jitter=0.0, flat=True), {}),
    "damping_saturation": (dict(lm_jitter=0.3, pose_jitter=0.05, nan_obs=True),
                           dict(max_damping=1e-1)),
    "max_iters_7": (dict(lm_jitter=0.3, pose_jitter=0.05),
                    dict(lm_rel_tol=1e-6, init_damping=1e4, max_lm_iters=7)),
    "max_iters_9": (dict(lm_jitter=0.3, pose_jitter=0.05),
                    dict(lm_rel_tol=1e-6, init_damping=1e4, max_lm_iters=9)),
}
# what each stop gives: (updating iterations, accepted steps)
LM_STOPS = {"rel_tol": (3, 3), "flat_reject": (1, 0), "damping_saturation": (5, 0),
            "max_iters_7": (8, 8), "max_iters_9": (10, 10)}


def _jax_lm_loop(jprob, jcam, jcfg):
    """The JAX ``lm_loop``, jitted, and its ``while_loop``'s final ``it``."""
    import jax

    from stereo_vo_tpu.backend import schur as jschur

    while_loop = jax.lax.while_loop
    carry = {}

    def recording(cond, body, init):
        out = while_loop(cond, body, init)
        carry["it"] = out[7]
        return out

    def run(p):
        return jschur.lm_loop(p, jcam, jcfg, None), carry["it"]

    jax.lax.while_loop = recording
    try:
        return jax.jit(run)(jprob)
    finally:
        jax.lax.while_loop = while_loop


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", list(LM_CASES))
def test_masked_lm_loop_matches_reference(case, seed):
    from stereo_vo_tpu.backend import schur as jschur
    from stereo_vo_tpu.core.camera import CameraInfo as JCameraInfo
    from stereo_vo_tpu.core.config import BackendConfig as JBackendConfig

    from torch_port_helpers import to_jax

    prob_kw, cfg_kw = LM_CASES[case]
    kw = dict(window_size=3, landmark_capacity=64, feature_capacity=64, max_features=64,
              **cfg_kw)
    prob = _lm_problem(seed, **prob_kw)
    jcam = JCameraInfo(**SMALL_CAM.__dict__)
    (jp, jl, jc0, jc1, jacc, _, jlam), jit = _jax_lm_loop(
        jschur.LandmarkMajorProblem(*to_jax(list(prob))), jcam, JBackendConfig(**kw))
    tp, tl, tc0, tc1, tacc, _, tlam, tit = tschur._lm_run(
        tschur.LandmarkMajorProblem(*to_torch(list(prob))), SMALL_CAM, BackendConfig(**kw))

    assert (int(tit), int(tacc)) == (int(jit), int(jacc)) == LM_STOPS[case]
    assert_equal(tlam, np.asarray(jlam), "final damping")
    if case == "damping_saturation":                      # NaN costs: nothing moved
        assert_equal(tp, np.asarray(prob.poses), "poses")
        return
    assert_close(tc0, jc0, atol=0, rtol=1e-5, what="initial cost")
    assert_close(tc1, jc1, atol=1e-6, rtol=1e-4, what="final cost")
    assert_close(tp, jp, atol=1e-4, what="poses")
    assert_close(tl, jl, atol=1e-3, rtol=1e-4, what="landmarks")


def _fixed_trip_lm_run(prob, cam, cfg, init_lam=None):
    """The oracle: the masked fixed trip of ``lm_trip(max_lm_iters)``
    bodies, every decision a ``torch.where``, the λ-free system rebuilt in
    every body and kept only after an accepted step; ``_lm_run``'s
    results."""
    from stereo_vo_tpu_torch.backend.schur import (
        BASystem,
        _build_system,
        _lm_major_cost,
        _solve_from_system,
    )

    poses, lm_pos = prob.poses, prob.lm_pos
    dtype, dev = poses.dtype, poses.device
    hd = cfg.huber_delta_px
    tol = cfg.lm_rel_tol
    cost0 = _lm_major_cost(poses, lm_pos, prob, cam, cfg.min_depth, hd)
    sys = _build_system(poses, lm_pos, prob, cam, cfg)
    if init_lam is None:
        lam = torch.full((), cfg.init_damping, dtype=dtype, device=dev)
    else:
        lam = torch.clamp(torch.as_tensor(init_lam, dtype=dtype, device=dev),
                          cfg.min_damping, cfg.max_damping)
    nu = torch.full((), 2.0, dtype=dtype, device=dev)
    cost = cost0
    accepted = torch.zeros((), dtype=torch.int32, device=dev)
    rel = torch.zeros((), dtype=dtype, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    it = torch.zeros((), dtype=torch.int32, device=dev)
    for _ in range(tschur.lm_trip(cfg.max_lm_iters)):
        cand_p, cand_l, pred = _solve_from_system(sys, poses, lm_pos, lam, cfg)
        cand_cost = _lm_major_cost(cand_p, cand_l, prob, cam, cfg.min_depth, hd)
        upd = ~done
        ok = (cand_cost < cost) & torch.isfinite(cand_cost) & upd
        poses = torch.where(ok, cand_p, poses)
        lm_pos = torch.where(ok, cand_l, lm_pos)
        cost_new = torch.where(ok, cand_cost, cost)
        rebuilt = _build_system(poses, lm_pos, prob, cam, cfg)
        sys = BASystem(*(torch.where(ok, new, old) for new, old in zip(rebuilt, sys)))
        rho = (cost - cand_cost) / torch.clamp(pred, min=1e-20)
        shrink = torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0)
        new_lam = torch.where(
            upd,
            torch.clamp(torch.where(ok, lam * shrink, lam * nu), cfg.min_damping,
                        cfg.max_damping),
            lam)
        nu = torch.where(upd, torch.where(ok, torch.full_like(nu, 2.0), nu * 2.0), nu)
        rel = torch.where(upd, torch.abs(cost - cost_new) / torch.clamp(cost, min=1e-20), rel)
        flat_reject = upd & ~ok & (
            torch.abs(cand_cost - cost) < tol * torch.clamp(cost, min=1e-20))
        done = done | (ok & (rel < tol)) | flat_reject | (upd & ~ok & (lam >= cfg.max_damping))
        lam = new_lam
        cost = cost_new
        accepted = accepted + ok.to(torch.int32)
        it = it + upd.to(torch.int32)
    return poses, lm_pos, cost0, cost, accepted, rel, lam, it


def _lm_case(case, seed):
    """``(torch problem, BackendConfig)`` of an ``LM_CASES`` case."""
    prob_kw, cfg_kw = LM_CASES[case]
    cfg = BackendConfig(window_size=3, landmark_capacity=64, feature_capacity=64,
                        max_features=64, **cfg_kw)
    prob = _lm_problem(seed, **prob_kw)
    return tschur.LandmarkMajorProblem(*to_torch(list(prob))), cfg


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", list(LM_CASES))
def test_lm_loop_is_the_fixed_trip_bitwise(case, seed):
    """The while loop with its conditional rebuild gives, bit for bit, what
    the masked fixed trip that rebuilds every body gives."""
    prob, cfg = _lm_case(case, seed)
    got = tschur._lm_run(prob, SMALL_CAM, cfg)
    want = _fixed_trip_lm_run(prob, SMALL_CAM, cfg)
    assert (int(got[7]), int(got[4])) == LM_STOPS[case]
    for g, w, what in zip(got, want, ("poses", "lm_pos", "cost0", "cost", "accepted", "rel",
                                      "lam", "it")):
        assert_equal(g, w, what)


@pytest.mark.parametrize("compact", [True, False])
def test_lm_loop_is_the_fixed_trip_bitwise_on_full_windows(small_window, large_window,
                                                           compact, monkeypatch):
    """As above inside ``bundle_adjust`` on the defaults' full windows,
    compacted and not, from the carried damping."""
    cfg = BackendConfig()
    window = small_window if compact else large_window
    run, pairs = tschur._lm_run, []

    def both(prob, cam, bcfg, init_lam=None, group=None):
        got = run(prob, cam, bcfg, init_lam, group)
        pairs.append((got, _fixed_trip_lm_run(prob, cam, bcfg, init_lam)))
        return got

    monkeypatch.setattr(tschur, "_lm_run", both)
    tschur.bundle_adjust(window, KITTI_CAM, cfg, compact=compact)
    (got, want), = pairs
    assert int(got[4]) > 0
    for g, w, what in zip(got, want, ("poses", "lm_pos", "cost0", "cost", "accepted", "rel",
                                      "lam", "it")):
        assert_equal(g, w, what)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", list(LM_CASES))
def test_lm_loop_builds_once_per_accepted_step(case, seed, monkeypatch):
    """The λ-free system is built once before the loop and once after each
    accepted step, never after a rejected one or after ``done``."""
    prob, cfg = _lm_case(case, seed)
    build, calls = tschur._build_system, []

    def counting(*args, **kwargs):
        calls.append(1)
        return build(*args, **kwargs)

    monkeypatch.setattr(tschur, "_build_system", counting)
    out = tschur._lm_run(prob, SMALL_CAM, cfg)
    assert len(calls) == 1 + int(out[4])


def test_lm_trip_is_the_reference_while_loop():
    """Pairs of bodies while fewer than max_lm_iters updated: the most
    bodies a solve runs."""
    assert [tschur.lm_trip(n) for n in range(1, 11)] == [2, 2, 4, 4, 6, 6, 8, 8, 10, 10]


# ---------------------------------------------------------------------------
# detection: the plain NMS against the jitted reference

def _frame(name):
    """``name``'s left image as float32 at 376x1241: a real frame, or frame 0
    of the photo world (seed 11) or of the billboard world."""
    if name == "real3":
        import cv2

        return cv2.imread(os.path.join(REAL, "image_0", "000003.png"),
                          cv2.IMREAD_GRAYSCALE).astype(np.float32)
    from stereo_vo_tpu_torch.data.synthetic import SyntheticStereoSequence, load_sample_photo

    cam = load_config("kitti00").camera
    world = (dict(n_frames=161, n_points=3000, seed=11, speed=0.9, yaw_rate=0.004,
                  texture=load_sample_photo()) if name == "photo0" else
             dict(n_frames=20, n_points=4000, seed=0, speed=0.8, yaw_rate=0.003))
    return SyntheticStereoSequence(cam=cam, shape=(376, 1241), **world).render(0)[0].astype(
        np.float32)


@pytest.mark.parametrize("name", ["real3", "photo0", "billboard0"])
def test_detect_corners_plain_matches_jitted_reference(name):
    import jax

    from stereo_vo_tpu.ops import shi_tomasi as jst

    from torch_port_helpers import to_jax

    fc = FrontendConfig()
    img = _frame(name)
    kw = dict(max_corners=fc.max_detect, quality_level=fc.quality_level,
              min_distance=fc.min_distance, block_size=fc.detect_block_size)
    want = jax.jit(lambda x: jst.detect_corners(x, **kw))(to_jax(img))
    got = tst.detect_corners(to_torch(img), **kw)
    assert int(got[2].sum()) > 50
    for g, w, what in zip(got, want, ("xy", "response", "valid")):
        assert_equal(g, w, what)


# ---------------------------------------------------------------------------
# on the card

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _nms_inputs(name, dev):
    """``(cxy, cvalid, r2)`` on ``dev`` for each of the kernel's cases."""
    fc = FrontendConfig()
    r2 = fc.min_distance * fc.min_distance
    if name.startswith("billboard") or name == "photo0":
        from stereo_vo_tpu_torch.data.synthetic import SyntheticStereoSequence, load_sample_photo

        cam = load_config("kitti00").camera
        if name == "photo0":
            world = SyntheticStereoSequence(cam=cam, shape=(376, 1241), n_frames=161,
                                            n_points=3000, seed=11, speed=0.9, yaw_rate=0.004,
                                            texture=load_sample_photo())
            img = world.render(0)[0]
        else:
            world = SyntheticStereoSequence(cam=cam, shape=(376, 1241), n_frames=20,
                                            n_points=4000, seed=0, speed=0.8, yaw_rate=0.003)
            img = world.render(int(name[9:]))[0]
        cxy, cvals = tst.corner_candidates(
            torch.from_numpy(img).to(dev).to(torch.float32), fc.quality_level,
            fc.min_distance, fc.detect_block_size)
        return cxy, cvals > 0, r2
    if name == "chain1024":              # each conflicts with its neighbours only
        x = torch.arange(1024, dtype=torch.float32)
        cxy = torch.stack([x, torch.full_like(x, 7.0)], 1)
        return cxy.to(dev), torch.ones(1024, dtype=torch.bool, device=dev), 4.0
    if name == "none_valid":
        cxy = torch.rand(1024, 2, generator=torch.Generator().manual_seed(0)) * 1000
        return cxy.floor().to(dev), torch.zeros(1024, dtype=torch.bool, device=dev), r2
    # image corners: clusters at the four corners of a 376x1241 frame
    gen = torch.Generator().manual_seed(1)
    corners = torch.tensor([[0.0, 0.0], [1240.0, 0.0], [0.0, 375.0], [1240.0, 375.0]])
    off = torch.randint(0, 40, (1024, 2), generator=gen).to(torch.float32)
    sign = torch.where(corners > 0, -1.0, 1.0)
    cxy = corners[torch.arange(1024) % 4] + off * sign[torch.arange(1024) % 4]
    valid = torch.rand(1024, generator=gen) < 0.9
    return cxy.to(dev), valid.to(dev), r2


def _nms_check_on_card(cxy, cvalid, r2, name):
    """The kernel bitwise its plain versions, one launch per call: the
    accepted set, and the capped pack at the default 300 detections and at
    40 (responses descending, -1 where invalid)."""
    before = tst.greedy_nms.launches
    got = tst.greedy_nms(cxy, cvalid, r2)
    torch.cuda.synchronize()
    assert tst.greedy_nms.launches == before + 1
    assert_equal(got.cpu(), tst.greedy_nms_ref(cxy, cvalid, r2).cpu(), name)
    c = cxy.shape[0]
    cvals = torch.where(cvalid, torch.linspace(2.0, 1.0, c, device=cxy.device), -1.0)
    for k in (300, 40):
        got = tst.greedy_nms(cxy, cvalid, r2, cvals, k)
        torch.cuda.synchronize()
        want = tst.greedy_nms_pack_ref(cxy, cvalid, cvals, r2, k)
        for g, w, what in zip(got, want, ("xy", "response", "valid")):
            assert_equal(g.cpu(), w.cpu(), f"{name} {what} at k={k}")
    assert tst.greedy_nms.launches == before + 3
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["billboard0", "billboard1", "billboard2", "billboard3",
                                  "billboard4", "photo0", "chain1024", "none_valid",
                                  "corners"])
def test_cuda_greedy_nms_equals_plain_version(name):
    dev = _card()
    cxy, cvalid, r2 = _nms_inputs(name, dev)
    _nms_check_on_card(cxy, cvalid, r2, name)
    got = tst.greedy_nms(cxy, cvalid, r2)
    if name == "chain1024":
        assert_equal(got.cpu(), (torch.arange(1024) % 2 == 0), "every other one")
    if name == "none_valid":
        assert not bool(got.any())


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["random1025_sparse", "random1500_sparse", "random1500_dense",
                                  "random4096_sparse", "random4096_dense", "single",
                                  "cell_borders", "ulp_pairs", "wide", "nonfinite"])
def test_cuda_greedy_nms_any_pool_size(name):
    """Over 1024 candidates (the dense 4096 pool's conflicts overflow the
    kernel's shared lists into bit rows) and at the edges of its binning."""
    from torch_port_helpers import nms_pool

    dev = _card()
    cxy, cvalid, r2 = nms_pool(name)
    _nms_check_on_card(torch.from_numpy(cxy).to(dev), torch.from_numpy(cvalid).to(dev), r2,
                       name)


@pytest.mark.cuda
def test_cuda_graph_replayed_keyframes_equal_eager():
    """Frames 0-7 of the 20-frame world (every step a keyframe) with the
    step replayed from its CUDA graph and run eagerly: every summary, and
    the final state, bitwise equal."""
    from stereo_vo_tpu_torch.data.synthetic import SyntheticStereoSequence
    from stereo_vo_tpu_torch.engine.step import VOEngine

    dev = _card()
    cfg = load_config("kitti00")
    world = SyntheticStereoSequence(cam=cfg.camera, shape=(376, 1241), n_frames=20,
                                    n_points=4000, seed=0, speed=0.8, yaw_rate=0.003)
    frames = [world.render(i) for i in range(8)]
    runs = {}
    for graphs in (True, False):
        engine = VOEngine(cfg, (376, 1241), device=dev, graphs=graphs)
        state, out = engine.bootstrap(engine.init_state(), *frames[0])
        rows = [out.summary.cpu()]
        for left, right in frames[1:]:
            state, out = engine.step(state, left, right)
            rows.append(out.summary.cpu())
        runs[graphs] = (torch.stack(rows), state, engine)
    assert int(runs[True][0][:, 7].sum()) >= 6                  # keyframes
    programs = list(runs[True][2].programs.values())
    assert len(programs) == 1 and programs[0].replays == len(frames) - 2
    # hinted, PnP, keyframe, two solves, and in each solve's LM loop (a
    # WHILE node in the solve's body) the rebuilds of its two bodies
    assert programs[0].conds == 9 and programs[0].whiles == 2
    assert sorted(b for b in programs[0].bodies if b[0] == "while") == [
        ("while", "lm_pair", 2)] * 2
    assert_equal(runs[True][0], runs[False][0], "summaries")
    from stereo_vo_tpu_torch.engine.graphs import flatten

    got, _ = flatten(runs[True][1])
    want, _ = flatten(runs[False][1])
    for g, w in zip(got, want):
        assert_equal(g.cpu(), w.cpu(), "state")
