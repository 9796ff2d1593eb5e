"""Frame-by-frame comparison of a run with a reference run of the same world.

The reference is the JAX package's ``run_vo`` on the CPU, stored by
``tests/fixtures/make_jax_reference.py`` as per-frame summary vectors
``[N, 19]``: the published pose ``[q, t]``, then ``SUMMARY_KEYS``.
``frame_differences`` reads two such arrays; ``run_summaries`` builds one
from a ``VORun``.
"""

from __future__ import annotations

import numpy as np

from stereo_vo_tpu_torch.engine.step import SUMMARY_KEYS

# the integer fields a port run must reproduce frame by frame
INT_KEYS = ("is_keyframe", "pnp_ok", "num_detected", "num_tracked", "num_inliers",
            "num_new_landmarks", "ba_iterations", "hinted")
BA_KEYS = ("ba_initial_cost", "ba_final_cost")


def run_summaries(run) -> np.ndarray:
    """``[N, 19]`` float32 summary vectors of a ``VORun``, in the layout of
    ``StepOutput.summary``."""
    rows = np.array([[float(s[k]) for k in SUMMARY_KEYS] for s in run.frame_stats],
                    np.float32).reshape(len(run.frame_stats), len(SUMMARY_KEYS))
    return np.concatenate([np.asarray(run.poses, np.float32), rows], axis=1)


def frame_differences(got: np.ndarray, want: np.ndarray) -> dict:
    """Per-frame differences of summaries ``got`` from ``want`` (both
    ``[N, 19]``): ``dq`` and ``dt``, the max |difference| of the quaternion
    and of the translation; ``got - want`` of each of ``INT_KEYS``; and the
    relative difference of each of ``BA_KEYS`` (against ``max(|want|,
    1e-12)``)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape:
        raise ValueError(f"summaries {got.shape} and {want.shape} differ in shape")
    col = {k: 7 + i for i, k in enumerate(SUMMARY_KEYS)}
    out = {"dq": np.abs(got[:, :4] - want[:, :4]).max(axis=1),
           "dt": np.abs(got[:, 4:7] - want[:, 4:7]).max(axis=1)}
    for k in INT_KEYS:
        out[k] = (got[:, col[k]] - want[:, col[k]]).astype(np.int64)
    for k in BA_KEYS:
        ref = np.maximum(np.abs(want[:, col[k]]), 1e-12)
        out[k] = np.abs(got[:, col[k]] - want[:, col[k]]) / ref
    return out


def departures(d: dict, frame: int, traj_tol: float, ba_rtol: float) -> dict:
    """What departs at ``frame`` of ``frame_differences`` output ``d``: each
    integer field that differs (by how much), ``"pose"`` when ``dq`` or
    ``dt`` exceeds ``traj_tol``, and each BA cost beyond relative
    ``ba_rtol``; empty when the frame holds."""
    out = {k: int(d[k][frame]) for k in INT_KEYS if d[k][frame]}
    pose = float(max(d["dq"][frame], d["dt"][frame]))
    if pose > traj_tol:
        out["pose"] = pose
    out.update({k: float(d[k][frame]) for k in BA_KEYS if d[k][frame] > ba_rtol})
    return out


def first_departure(d: dict, traj_tol: float, ba_rtol: float):
    """``(frame, departures)`` at the first frame of ``d`` that does not
    hold (see ``departures``), or ``(None, {})`` when every frame holds."""
    for i in range(len(d["dq"])):
        what = departures(d, i, traj_tol, ba_rtol)
        if what:
            return i, what
    return None, {}


def keyframe_ate(summaries: np.ndarray, gt_poses: np.ndarray):
    """``(aligned keyframe ATE rmse in metres, keyframe count)`` of a run's
    summaries against the world's ground-truth poses."""
    from stereo_vo_tpu_torch.eval.ate import absolute_trajectory_error

    summaries = np.asarray(summaries)
    kf = summaries[:, 7].astype(bool)
    gt = np.asarray(gt_poses)[: len(kf)]
    return absolute_trajectory_error(summaries[kf, :7], gt[kf], align=True)["rmse"], int(kf.sum())


def reference_spread(want: np.ndarray, reruns: np.ndarray, traj_tol: float, ba_rtol: float):
    """The reference's own float32 spread: per frame, the largest departure
    of its nudged reruns ``reruns [T, N, 19]`` from it (``|difference|`` for
    the integer fields, ``"pose"`` for ``max(dq, dt)``), and the sorted frames
    where a rerun first departs."""
    diffs = [frame_differences(r, want) for r in reruns]
    out = {k: np.max([np.abs(d[k]) for d in diffs], axis=0) for k in (*INT_KEYS, *BA_KEYS)}
    out["pose"] = np.max([np.maximum(d["dq"], d["dt"]) for d in diffs], axis=0)
    firsts = {first_departure(d, traj_tol, ba_rtol)[0] for d in diffs}
    return out, sorted(f for f in firsts if f is not None)


def beyond_spread(what: dict, spread: dict, frame: int, factor: float) -> dict:
    """The fields of a ``departures`` dict beyond ``factor`` times the
    reruns' largest departure at ``frame``."""
    return {k: v for k, v in what.items() if abs(v) > factor * spread[k][frame]}


def divergence_hold(got: np.ndarray, want: np.ndarray, reruns: np.ndarray, gt_poses,
                    traj_tol: float, ba_rtol: float, spread_factor: float,
                    ate_rtol: float) -> dict:
    """A run held to the reference by the divergence rule.

    The run holds frame by frame (integer fields equal, pose within
    ``traj_tol``, BA costs within relative ``ba_rtol``) up to its first
    departure. That departure may come no earlier than the first of the
    nudged reruns ``reruns`` (the reference's own float32 spread), and what
    departs there must lie within ``spread_factor`` times the reruns' largest
    departure at that frame. From there on the trajectories part, and the run
    is held by its keyframe count, within the range of the reference runs
    (``want`` and ``reruns``), and its aligned keyframe ATE, within
    ``ate_rtol`` of their range.

    Returns a report: the first departure's ``frame`` (None if none), what
    departed (``departed``) and the reruns' largest departure there
    (``spread_at_frame``), the reruns' first departures, keyframes and ATE of
    the run and of the reference runs, and ``failures``, empty when the run
    holds."""
    n = len(got)
    want, reruns = np.asarray(want)[:n], np.asarray(reruns)[:, :n]
    d = frame_differences(got, want)
    spread, firsts = reference_spread(want, reruns, traj_tol, ba_rtol)
    frame, why = first_departure(d, traj_tol, ba_rtol)
    ate, kf = keyframe_ate(got, gt_poses)
    ref_runs = [keyframe_ate(s, gt_poses) for s in (want, *reruns)]
    report = {
        "frames": n, "frame": frame, "departed": why,
        "spread_at_frame": ({k: float(spread[k][frame]) for k in why} if why else {}),
        "reruns_first_departures": firsts, "keyframes": kf, "ate": ate,
        "reference_keyframes": [r[1] for r in ref_runs],
        "reference_ate": [r[0] for r in ref_runs], "failures": [],
    }
    if frame is None:
        return report
    fail = report["failures"]
    if not firsts or frame < firsts[0]:
        fail.append(f"departs at frame {frame} ({why}), before the reference departs from "
                    f"itself ({firsts})")
    beyond = beyond_spread(why, spread, frame, spread_factor)
    if beyond:
        fail.append(f"at frame {frame} beyond {spread_factor} x the reference's own spread: "
                    f"{beyond}")
    kfs, ates = report["reference_keyframes"], report["reference_ate"]
    if not min(kfs) <= kf <= max(kfs):
        fail.append(f"{kf} keyframes, reference runs {kfs}")
    if not (1 - ate_rtol) * min(ates) <= ate <= (1 + ate_rtol) * max(ates):
        fail.append(f"keyframe ATE {ate} m, reference runs {ates}")
    return report


def pose_differences(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Per row of poses ``a``, ``b [H, 7]``: the largest |difference| over
    the components finite in both, inf where one is finite and the other
    not."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    fa, fb = np.isfinite(a), np.isfinite(b)
    d = np.where(fa & fb, np.abs(a - b), 0.0).max(axis=1)
    return np.where((fa != fb).any(axis=1), np.inf, d)


def hypothesis_hold(got, want, got_nudged, want_nudged, tol: float,
                    spread_factor: float) -> dict:
    """PnP hypotheses ``got`` held to ``want``, each ``(pose [H, 7], ok
    [H])`` from the same samples, with each side's rerun on inputs nudged by
    one ulp (``*_nudged``) measuring what float32 rounding alone moves.

    Scoring gives a hypothesis that is not ok no inliers, so only an ok
    hypothesis's pose is compared. Its spread is the larger move under the
    nudge of a side's pose where that side is ok, inf where a side's ok
    flips. Where the
    spread exceeds ``tol``, rounding decides the hypothesis (an
    ill-conditioned sample: repeated or coplanar points, or outliers the
    polish cannot fit) and it is counted but not compared. Every other
    hypothesis holds when its ok flags are equal and, where ok, its pose
    lies within ``tol + spread_factor * spread`` of ``want`` (non-finite in
    the same components).

    Returns the hypotheses' count, how many rounding decides, the failures'
    indices, and the largest pose difference and spread among the compared
    ok ones."""
    (gp, gok), (wp, wok) = [(np.asarray(p), np.asarray(ok)) for p, ok in (got, want)]
    (gp2, gok2), (wp2, wok2) = [(np.asarray(p), np.asarray(ok))
                                for p, ok in (got_nudged, want_nudged)]
    both = gok & wok
    spread = np.maximum(np.where(gok, pose_differences(gp, gp2), 0.0),
                        np.where(wok, pose_differences(wp, wp2), 0.0))
    spread = np.where((gok != gok2) | (wok != wok2), np.inf, spread)
    d = np.where(both, pose_differences(gp, wp), 0.0)
    decided = spread > tol
    failed = ~decided & ((gok != wok) | (d > tol + spread_factor * spread))
    held = ~decided & both
    return {"n": len(d), "rounding_decided": int(decided.sum()),
            "failed": np.nonzero(failed)[0].tolist(),
            "max_diff": float(d[held].max()) if held.any() else 0.0,
            "max_spread": float(spread[held].max()) if held.any() else 0.0}
