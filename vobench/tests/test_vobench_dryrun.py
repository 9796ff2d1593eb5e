"""Both mixes end to end on the CPU at a small size (the port's eager CPU
path), the reference against the port bitwise there, and the faults a
timed path can have seen to turn ``correct`` false."""

import numpy as np
import pytest
import torch

from vobench import check, run
from vobench.world import render_frames
from vobench.tests.helpers import small_cell


def _logs():
    lines = []
    return lines, lines.append


@pytest.mark.parametrize("name", ["kitti00.replay", "d435i.stream"])
@pytest.mark.parametrize("trace", [0, 1])
def test_dry_run(name, trace):
    cell = small_cell(name)
    lines, log = _logs()
    res = run.run_cell(cell, 2**31 + 11, 2.0, bool(trace), device="cpu", log=log)
    assert res["correct"] is True
    assert list(res)[-1] == "check" and set(res["check"]) == set(cell.config["limits"])
    assert set(cell.config["limits"]) <= set(check.NUMBERS)
    # the port's CPU path is the reference's bitwise; its trajectory is its own
    assert all(c["value"] == 0.0 for k, c in res["check"].items() if k != "traj_err")
    assert all(c["value"] <= c["limit"] for c in res["check"].values())
    assert res["attempted"] >= 1 and res["failed"] == 0
    got = set(res["metrics"])
    if trace:
        # on the CPU there are no CUDA events and no profile, and a short
        # window may hold no keyframe step: those readers read nothing
        assert got <= {m["name"] for m in cell.per_layer}
        assert ("cruise_step_ms" in got) == (cell.traffic["mode"] == "stream")
    else:
        assert got == {m["name"] for m in cell.end_to_end}
    assert any(line.startswith("window passes against the warm pass: largest difference 0.0")
               for line in lines)


def test_reference_pool_steps_as_this_process_does():
    """The check's steps in a pool of spawned processes come out as the same
    steps made here."""
    from stereo_vo_tpu_torch.engine.step import VOEngine, parse_summary
    from vobench.drive import Driver, StateTap

    cell = small_cell("kitti00.stream", frames=5)
    lefts, rights = render_frames(cell.config, 5, 6)
    engine = VOEngine(run.port_config(cell.config), lefts.shape[1:], device="cpu")
    sample = [0, 2, 4]
    with StateTap(engine, sample) as tap:
        summaries = Driver(engine, parse_summary, lefts, rights, cell.traffic).run(
            0.0, whole_passes=True).passes[0].summaries
    here = run.stepwise_pairs(cell.config, lefts, rights, summaries, tap, sample)
    pool = run.reference_pool(2)
    try:
        pooled = run.stepwise_pairs(cell.config, lefts, rights, summaries, tap, sample, pool)
    finally:
        run.close_pool(pool)
    assert len(here) == len(pooled) == 3
    for a, b in zip(here, pooled):
        assert np.array_equal(a[1], b[1])
        assert np.array_equal(check.state_poses(a[3]), check.state_poses(b[3]))
        assert np.array_equal(check.state_counts(a[3]), check.state_counts(b[3]))


@pytest.mark.parametrize("mode", ["stream", "replay"])
def test_reference_is_the_ports_cpu_path_bitwise(mode):
    from stereo_vo_tpu_torch.engine.step import VOEngine, parse_summary
    from vobench.drive import Driver

    cell = small_cell("kitti00." + mode, frames=6, chunk=2)
    lefts, rights = render_frames(cell.config, 6, 4)
    ref = np.asarray(run.reference_pass(cell.config, cell.traffic, lefts, rights)[0].summaries)
    threads = torch.get_num_threads()
    torch.set_num_threads(run.REFERENCE_THREADS)
    try:
        engine = VOEngine(run.port_config(cell.config), lefts.shape[1:], device="cpu")
        win = Driver(engine, parse_summary, lefts, rights, cell.traffic).run(
            0.0, whole_passes=True)
    finally:
        torch.set_num_threads(threads)
    assert np.array_equal(np.asarray(win.passes[0].summaries), ref)


def _unchanged_state(engine, travel):
    step = engine.step

    def stuck(state, left, right, **kw):
        return state, step(state, left, right, **kw)[1]

    engine.step = stuck


def _altered_answer(engine, travel):
    """Each step's published pose moved by one frame's travel along x."""
    step = engine.step

    def altered(state, left, right, **kw):
        state, out = step(state, left, right, **kw)
        bump = torch.zeros_like(out.summary)
        bump[4] = travel
        return state, out._replace(summary=out.summary + bump)

    engine.step = altered


def _half_batch(engine, travel):
    replay = engine.replay_chunk

    def half(state, lefts, rights):
        k = lefts.shape[0]
        state, poses, summ = replay(state, lefts[: (k + 1) // 2], rights[: (k + 1) // 2])
        pad = summ[-1:].expand(k - summ.shape[0], -1)
        summ = torch.cat([summ, pad])
        return state, summ[:, :7], summ

    engine.replay_chunk = half


@pytest.mark.parametrize("name,fault", [
    ("kitti00.stream", _unchanged_state), ("d435i.stream", _unchanged_state),
    ("kitti00.replay", _unchanged_state),
    ("kitti00.replay", _altered_answer), ("d435i.stream", _altered_answer),
    ("kitti00.replay", _half_batch),
])
def test_a_broken_timed_path_is_not_correct(name, fault):
    """The run as the card makes it, the look for a card skipped, with the
    timed path broken underneath: ``correct`` comes out false against the
    configuration's own limits."""
    cell = small_cell(name, frames=9, chunk=4)
    travel = cell.config["world"]["speed"] * cell.config["world"]["scale"]
    lines, log = _logs()
    res = run.run_cell(cell, 77, 3.0, False, device="cpu",
                       engine_hook=lambda e: fault(e, travel), log=log)
    assert res["correct"] is False, res["check"]
