"""The control of the comparison that decides ``correct``: the plain
reference computed in TF32 (``reference/tf32.py``) put in the program's
place, held against the reference, at the cell's own size. Its readings
set the upper end of each limit (PERF.md); the benchmark's own runs never
run it (``vobench/readings.py`` does). CPU only.
"""

from __future__ import annotations

from vobench import check, run, world


def control_rows(config: dict, traffic: dict, lefts, rights, gt, sample):
    """The control's free pass over the frames and the float32 reference
    stepped from its states at ``sample``: ``(rows, traj_err)``."""
    travel = config["world"]["speed"] * config["world"]["scale"]
    ctl, tap = run.reference_pass(config, traffic, lefts, rights, True, sample)
    pairs = run.stepwise_pairs(config, lefts, rights, ctl.summaries, tap, sample)
    return check.frame_rows(pairs, travel), check.traj_err(ctl.summaries, gt, travel)


def readings(cell, seed: int) -> dict:
    """The compared numbers of the control on one seed of ``cell``."""
    n = int(cell.traffic["pass_frames"])
    lefts, rights = world.render_frames(cell.config, n, seed)
    sample = run.stepwise_sample(cell.config, n, seed)
    rows, traj = control_rows(cell.config, cell.traffic, lefts, rights,
                              world.gt_poses(cell.config, n, seed), sample)
    return dict(check.step_numbers(rows), traj_err=traj)
