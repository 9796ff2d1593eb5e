"""The comparison that decides ``correct``.

The plain reference (``vobench/reference``, on the CPU) follows the program
step by step from the program's own state. Two free runs of this VO, the
card's and the CPU's, part on float32 rounding alone: a keyframe, RANSAC or
LM decision flips and the trajectories drift apart (PERF.md §6), so a free
run's gap measures the world's conditioning, not the program. So the
reference works out again, from the same frames, the bootstrap from its own
``init_state()`` (the start, held by itself), and each frame of a sample
drawn from the seed, stepped through the same entry (``bootstrap`` or
``step``, the call ``replay_chunk`` makes for each of its frames) from the
state the program was given for that frame, and compares the summary and
the state that come out with the program's. The program's states and
summaries come from the warm pass (``drive.StateTap``), which every pass of
the window repeats bitwise: ``warm_gap``, the largest difference between
any window pass's summaries and the warm pass's, is held at 0, so what is
compared is what the window produced.

Each checked frame gives a row (``frame_row``): the largest gap between
the program's and the reference's poses (the published pose and the
state's ``cur_pose``, ``pnp_pose`` and valid window poses; quaternion
components with the sign that brings them closer; translations, and the
live landmarks' positions, in units of the world's travel per frame,
``speed * scale``, so one limit reads alike at every scale). A single step
can take the other side of a threshold (a RANSAC, keyframe or LM decision)
on a float32 rounding, and that one frame then reads far off on sound runs
and on the control alike (PERF.md §6), so the numbers compared are medians
over the sampled keyframe steps, where a lower precision moves every step
and one flipped decision moves none of the medians:

- ``kf_lm_median``, ``kf_quat_median``, ``kf_trans_median``: the median over
  the sampled steps whose program summary says keyframe, of the landmark
  gap, the quaternion gap and the translation gap;
- ``frame_idx_gap``: the largest difference of the state's frame index, an
  exact count: a step that hands back its state unchanged, or steps twice,
  reads 1 or more;
- ``traj_err`` (``traj_err``): the program's pass against the
  world's ground truth, a number no code of the program's computes;
- ``warm_gap`` (above);
- printed: ``quat_gap``, ``trans_gap`` (the largest over the frames) and
  ``int_frames`` (the frames whose integer fields, keyframe and PnP flags,
  detected, tracked, inlier and new-landmark counts, BA iterations, the
  hint flag, or state counts, frame index, features at init, tracked
  features, live landmarks, keyframes, valid window poses, differ): they
  show a flipped decision.

A pose that is not finite reads as infinitely far.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

# the summary's layout: the pose [7], then SUMMARY_KEYS
INT_FIELDS = {"is_keyframe": 7, "pnp_ok": 8, "num_detected": 9, "num_tracked": 10,
              "num_inliers": 11, "num_new_landmarks": 12, "ba_iterations": 17, "hinted": 18}
NUMBERS = ("quat_gap", "trans_gap", "int_frames", "frame_idx_gap", "kf_quat_median",
           "kf_trans_median", "kf_lm_median", "traj_err", "warm_gap")


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number that has a limit at or under it (a NaN fails); a number
    without one is printed, not compared."""
    return all(numbers[k] <= limits[k] for k in limits)


def pass_spread(passes: List[List[np.ndarray]]) -> float:
    """The largest difference between any pass's summaries and the first's,
    over the frames both finished (0 when the program repeats itself
    bitwise; NaN when a summary is)."""
    first = np.asarray(passes[0], np.float64)
    worst = 0.0
    for p in passes[1:]:
        if p:
            a = np.asarray(p, np.float64)
            n = min(len(a), len(first))
            worst = max(worst, float(np.max(np.abs(a[:n] - first[:n]))))
    return worst


def _pose_gaps(a: np.ndarray, b: np.ndarray, travel: float):
    """Quaternion and translation gaps of two ``[..., 7]`` pose arrays."""
    a = np.asarray(a, np.float64).reshape(-1, 7)
    b = np.asarray(b, np.float64).reshape(-1, 7)
    if not np.all(np.isfinite(a)):
        return float("inf"), float("inf")
    dq = np.minimum(np.abs(a[:, :4] - b[:, :4]).max(axis=1),
                    np.abs(a[:, :4] + b[:, :4]).max(axis=1))
    dt = np.linalg.norm(a[:, 4:] - b[:, 4:], axis=1) / travel
    return float(dq.max(initial=0.0)), float(dt.max(initial=0.0))


def state_poses(state) -> np.ndarray:
    """The poses a ``VOState`` carries: ``cur_pose``, ``pnp_pose`` and the
    window's valid poses."""
    w = state.window
    valid = w.pose_valid.numpy()
    return np.concatenate([state.cur_pose.numpy()[None], state.pnp_pose.numpy()[None],
                           w.poses.numpy()[valid]])


def state_counts(state) -> np.ndarray:
    w, t = state.window, state.tracker
    return np.array([int(state.frame_idx), int(state.initialized), int(t.init_count),
                     int(t.feat_valid.sum()), int(w.lm_valid.sum()), int(w.num_kf),
                     int(w.pose_valid.sum())])


def frame_row(prog, ref, prog_state, ref_state, travel: float) -> Dict[str, float]:
    """One checked frame's gaps between the program and the reference: the
    pose gaps (``dq``, ``dt``), whether an integer field or a state count
    differs (``ints``), the state's frame-index gap (``fidx``), the largest
    gap of the live landmarks' positions in travel per frame (``lm``, where
    both hold the same landmarks; infinite otherwise) and whether the
    program's step made a keyframe (``kf``)."""
    prog, ref = np.asarray(prog, np.float64), np.asarray(ref, np.float64)
    dq, dt = _pose_gaps(prog[:7], ref[:7], travel)
    pa, pb = state_poses(prog_state), state_poses(ref_state)
    sq, st = _pose_gaps(pa, pb, travel) if pa.shape == pb.shape else (np.inf, np.inf)
    ints = list(INT_FIELDS.values())
    counts_differ = not np.array_equal(state_counts(prog_state), state_counts(ref_state))
    wa, wb = prog_state.window, ref_state.window
    va, vb = wa.lm_valid.numpy(), wb.lm_valid.numpy()
    if np.array_equal(va, vb):
        d = np.abs(wa.lm_pos.numpy()[va].astype(np.float64) - wb.lm_pos.numpy()[vb])
        lm = float(np.max(d, initial=0.0)) / travel
        lm = lm if np.isfinite(lm) else float("inf")
    else:
        lm = float("inf")
    return {"dq": max(dq, sq), "dt": max(dt, st),
            "ints": float(np.any(prog[ints] != ref[ints]) or counts_differ),
            "fidx": float(abs(int(prog_state.frame_idx) - int(ref_state.frame_idx))),
            "lm": lm, "kf": float(prog[INT_FIELDS["is_keyframe"]] != 0)}


def frame_rows(pairs, travel: float) -> List[Dict[str, float]]:
    """``frame_row`` of each checked frame of ``pairs`` (``(program summary,
    reference summary, program state, reference state)``, the states on the
    host); None for a frame whose call the program never made."""
    return [None if ref is None else frame_row(prog, ref, ps, rs, travel)
            for prog, ref, ps, rs in pairs]


def _median(values) -> float:
    return float(np.median(values)) if len(values) else 0.0


def step_numbers(rows) -> Dict[str, float]:
    """The compared numbers over the checked frames' rows (module doc)."""
    if any(r is None for r in rows):
        return {k: float("inf") for k in NUMBERS if k not in ("warm_gap", "traj_err")}
    kf = [r for r in rows if r["kf"]]
    return {
        "quat_gap": max((r["dq"] for r in rows), default=0.0),
        "trans_gap": max((r["dt"] for r in rows), default=0.0),
        "int_frames": float(sum(r["ints"] for r in rows)),
        "frame_idx_gap": max((r["fidx"] for r in rows), default=0.0),
        "kf_quat_median": _median([r["dq"] for r in kf]),
        "kf_trans_median": _median([r["dt"] for r in kf]),
        "kf_lm_median": _median([r["lm"] for r in kf]),
    }


def step_gaps(pairs, travel: float) -> Dict[str, float]:
    """``step_numbers`` of ``pairs``."""
    return step_numbers(frame_rows(pairs, travel))


def _centers(poses: np.ndarray) -> np.ndarray:
    """Camera centers ``-R^T t`` of ``[N, 7]`` ``T_cw`` poses (unit
    quaternion ``w, x, y, z`` first)."""
    p = np.asarray(poses, np.float64)
    q = p[:, :4] / np.linalg.norm(p[:, :4], axis=1, keepdims=True)
    w, x, y, z = q.T
    r = np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)
    return -np.einsum("nji,nj->ni", r, p[:, 4:])


def traj_err(summaries, gt: np.ndarray, travel: float) -> float:
    """The root mean square, over a pass's keyframes (the frames whose pose
    the VO estimates; between them it publishes the last keyframe's), of
    the distance between the published camera center and the ground
    truth's, in travel per frame: the pose the world starts at is the VO's
    origin, so nothing is aligned. Infinite where a pose is not finite or
    the pass has no keyframe."""
    s = np.asarray(summaries, np.float64)
    kf = s[:, INT_FIELDS["is_keyframe"]] != 0 if len(s) else np.zeros(0, bool)
    poses = s[kf, :7] if len(s) else s
    if not len(poses) or not np.all(np.isfinite(poses)):
        return float("inf")
    err = np.linalg.norm(_centers(poses) - _centers(gt[:len(s)][kf]), axis=1) / travel
    return float(np.sqrt(np.mean(err * err)))
