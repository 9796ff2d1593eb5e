"""The engine's span recorder (``VOEngine(..., trace=True)``,
``utils/profiling.py::Recorder``).

On the CPU, where a device stamp is a host clock read:
- a streamed run gives every frame one ``step`` span with its ``track``
  inside; ``pnp`` runs exactly on the frames the gate accepts (derived from
  the summaries' counts against the gate's thresholds), ``kf_prep`` and
  ``ba`` exactly on keyframes; parents and frame ids agree and self times
  are non-negative; a chunked replay nests its steps in ``replay_chunk``;
- ``trace=False`` makes no stamp and gives bitwise the states and summaries
  of ``trace=True``; a tiny ring counts what it drops; the untaken side of
  a warming ``cond`` records nothing;
- ``assemble`` on hand-made records: self times, the idle split by host
  span, a missing end; ``profile_spans.py``'s readings on hand-made traces,
  and None where their spans are absent or records were dropped;
- ``run_vo(trace=True)`` and ``svo-torch run --trace`` write ``spans.json``.

The ``cuda`` tests need the card (``python -m pytest
tests/test_torch_tracing.py -m cuda --noconftest -q``): the stamp kernel and
the device clock's tick; on the 20-frame world in graph mode, the ``ba``
spans number the solve bodies' runs that ``Program.runs`` counts; graph and
eager runs give the same spans per frame; each device span begins after the
host span that enqueued it, within the calibration's error; and with
``trace=False`` the step graph has the traced one's bodies and launch
counts and no stamp is launched.
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from stereo_vo_tpu_torch.core.camera import CameraInfo
from stereo_vo_tpu_torch.core.config import BackendConfig, FrontendConfig, PipelineConfig
from stereo_vo_tpu_torch.data.synthetic import SyntheticStereoSequence
from stereo_vo_tpu_torch.engine import graphs
from stereo_vo_tpu_torch.engine.step import VOEngine, parse_summary
from stereo_vo_tpu_torch.utils import profiling
from stereo_vo_tpu_torch.utils.profiling import DEVICE, HOST, SPANS, Recorder, assemble

from torch_port_helpers import assert_equal

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (240, 320)
N_FRAMES = 10
LAYERS = ("track", "pnp", "kf_prep", "ba")


def _config():
    return PipelineConfig(
        camera=CameraInfo(focal=400.0, cx=160.0, cy=120.0, baseline=0.5),
        frontend=FrontendConfig(min_distance=12.0, parallax_thresh=10.0),
        backend=BackendConfig(feature_capacity=384, landmark_capacity=1024, max_lm_iters=8),
    )


@pytest.fixture(scope="module")
def frames():
    world = SyntheticStereoSequence(cam=_config().camera, n_frames=N_FRAMES, shape=SHAPE,
                                    n_points=500, seed=11, speed=0.35, yaw_rate=0.004,
                                    point_depth=(5.0, 18.0))
    return [world.render(i) for i in range(N_FRAMES)]


def _stream(engine, frames):
    """Bootstrap until a keyframe, then step: ``(state, summary rows)``."""
    state, rows, booted = engine.init_state(), [], False
    for left, right in frames:
        fn = engine.step if booted else engine.bootstrap
        state, out = fn(state, left, right)
        rows.append(out.summary.clone())
        booted = booted or parse_summary(out.summary)[1]["is_keyframe"]
    return state, rows


@pytest.fixture(scope="module")
def traced(frames):
    engine = VOEngine(_config(), SHAPE, device="cpu", trace=True)
    state, rows = _stream(engine, frames)
    return state, rows, engine.trace_records()


def _by_call(trace):
    out = {}
    for s in trace.spans:
        out.setdefault(s.call, []).append(s)
    return out


def test_every_frame_one_step_span_with_track_inside(traced):
    _, rows, trace = traced
    calls = _by_call(trace)
    assert len(calls) == len(rows) and trace.dropped == 0
    booting = True
    for k, call in enumerate(sorted(calls)):
        names = sorted((s.clock, s.name) for s in calls[call])
        if booting:
            assert names == [(DEVICE, "bootstrap"), (HOST, "bootstrap")]
            booting = not parse_summary(rows[k])[1]["is_keyframe"]
            continue
        step = [s for s in calls[call] if (s.clock, s.name) == (DEVICE, "step")]
        track = [s for s in calls[call] if s.name == "track"]
        assert len(step) == 1 and len(track) == 1
        assert step[0].begin_ns <= track[0].begin_ns <= track[0].end_ns <= step[0].end_ns


def test_pnp_on_accepted_frames_kf_prep_and_ba_on_keyframes(traced):
    _, rows, trace = traced
    fc = _config().frontend
    calls = _by_call(trace)
    steps = [c for c in sorted(calls) if any(s.name == "step" for s in calls[c])]
    summaries = [parse_summary(r)[1] for r in rows[len(rows) - len(steps):]]
    accepted = keyframes = 0
    for call, row in zip(steps, summaries):
        names = [s.name for s in calls[call] if s.clock == DEVICE]
        accept = (row["num_detected"] >= fc.min_detected
                  and (np.float32(row["av_parallax"]) > np.float32(fc.parallax_thresh)
                       or np.float32(row["percent_lost"]) >= np.float32(fc.lost_thresh)))
        assert names.count("pnp") == int(accept)
        assert names.count("kf_prep") == names.count("ba") == int(row["is_keyframe"])
        accepted += accept
        keyframes += row["is_keyframe"]
    assert keyframes >= 2 and accepted >= keyframes


def test_parents_frame_ids_and_self_times(traced):
    _, rows, trace = traced
    spans = trace.spans
    assert [s.begin_ns for s in spans] == sorted(s.begin_ns for s in spans)
    for s in spans:
        assert s.end_ns >= s.begin_ns and 0 <= s.self_ns <= s.end_ns - s.begin_ns
        up = SPANS[(s.clock, s.name)]
        if s.clock == HOST:
            assert s.parent is None      # no replay_chunk in a streamed run
        else:
            p = spans[s.parent]
            assert (p.clock, p.name) == up and p.call == s.call and p.frame == s.frame
            assert p.begin_ns <= s.begin_ns <= s.end_ns <= p.end_ns
    # the frame id is the state's frame index when the call began, on every
    # span of the call
    frames = [s.frame for s in spans if (s.clock, s.name) in ((DEVICE, "step"),
                                                              (DEVICE, "bootstrap"))]
    assert frames == list(range(len(rows)))
    calls = _by_call(trace)
    assert all(len({s.frame for s in calls[c]}) == 1 for c in calls)
    # the step's self time leaves out what its layers cover
    for step in (s for s in spans if s.name == "step"):
        kids = [s for s in spans if s.parent is not None and spans[s.parent] is step]
        assert step.self_ns == step.end_ns - step.begin_ns - sum(k.end_ns - k.begin_ns
                                                                 for k in kids)


def test_trace_off_records_nothing_and_changes_nothing(frames, traced, monkeypatch):
    stamps = []
    monkeypatch.setattr(Recorder, "_stamp", lambda self, *a: stamps.append(a))
    engine = VOEngine(_config(), SHAPE, device="cpu")
    assert engine.recorder is None
    state, rows = _stream(engine, frames)
    assert stamps == []
    with pytest.raises(ValueError):
        engine.trace_records()
    want_state, want_rows, _ = traced
    assert_equal(torch.stack(rows), torch.stack(want_rows), "summaries")
    for g, w in zip(graphs.flatten(state)[0], graphs.flatten(want_state)[0]):
        assert_equal(g, w, "state")


def test_a_tiny_ring_counts_drops(frames, traced):
    engine = VOEngine(_config(), SHAPE, device="cpu", trace=True)
    engine.recorder = Recorder("cpu", capacity=5)
    _stream(engine, frames)
    trace = engine.trace_records()
    made = 2 * sum(1 for s in traced[2].spans if s.clock == DEVICE)
    assert trace.dropped == made - 5 > 0
    assert len(trace.named("step.enqueue", HOST)) == len(traced[2].named("step.enqueue", HOST))
    assert len([s for s in trace.spans if s.clock == DEVICE]) <= 5 // 2
    # a drain starts the ring afresh: one bootstrap's two records fit
    _stream(engine, frames[:1])
    assert engine.trace_records().dropped == 0


def test_replay_chunk_nests_its_steps(frames):
    engine = VOEngine(_config(), SHAPE, device="cpu", trace=True)
    state, rows = _stream(engine, frames[:4])
    engine.trace_records()
    lefts = np.stack([f[0] for f in frames[4:]])
    rights = np.stack([f[1] for f in frames[4:]])
    state, _, summaries = engine.replay_chunk(state, lefts, rights)
    trace = engine.trace_records()
    chunk = trace.named("replay_chunk", HOST)
    pre = trace.named("preprocess")
    enq = trace.named("step.enqueue", HOST)
    assert len(chunk) == len(pre) == 1 and len(enq) == len(trace.named("step")) == len(lefts)
    k = trace.spans.index(chunk[0])
    assert trace.spans[pre[0].parent] is chunk[0] and all(s.parent == k for s in enq)
    assert pre[0].frame == enq[0].frame == 4 and [s.frame for s in enq] == list(range(4, 10))
    # the chunk's self time leaves out its steps' host spans
    assert chunk[0].self_ns == (chunk[0].end_ns - chunk[0].begin_ns
                                - sum(s.end_ns - s.begin_ns for s in enq))
    assert summaries.shape[0] == len(lefts)


def test_warming_discards_the_untaken_side():
    rec = Recorder("cpu")

    def side(name):
        def fn(x):
            with rec.span(name):
                return x + 1
        return fn

    def call():
        return graphs.cond(torch.tensor(True), side("pnp"), side("ba"), (torch.zeros(2),))

    with graphs.warming():
        rec.call("step.enqueue", "step", torch.tensor(3, dtype=torch.int32), call)
    names = [s.name for s in rec.drain().spans]
    assert sorted(names) == ["pnp", "step", "step.enqueue"]


def _records(spec):
    """Hand-made records: ``spec`` rows ``(clock, name, call, begin, end,
    frame or parent call)``, one begin and one end record each."""
    dev, host = [], []
    code = {key: 2 * k for k, key in enumerate(SPANS)}
    for clock, name, call, t0, t1, extra in spec:
        c = code[(clock, name)]
        if clock == DEVICE:
            dev += [(t0, c, extra, call), (t1, c + 1, extra, call)]
        else:
            host += [(t0, c, call, extra), (t1, c + 1, call, extra)]
    return sorted(dev), sorted(host)


# a stream window of three steps, the second a keyframe, times in us
STREAM = [
    (HOST, "step.enqueue", 1, 0, 300, 0), (DEVICE, "step", 1, 100, 1100, 7),
    (DEVICE, "track", 1, 200, 700, 7),
    (HOST, "step.enqueue", 2, 2000, 2400, 0), (DEVICE, "step", 2, 2100, 9100, 8),
    (DEVICE, "track", 2, 2200, 2800, 8), (DEVICE, "pnp", 2, 2900, 6900, 8),
    (DEVICE, "kf_prep", 2, 7000, 8000, 8), (DEVICE, "ba", 2, 8000, 9000, 8),
    (HOST, "step.enqueue", 3, 10000, 10200, 0), (DEVICE, "step", 3, 10100, 11100, 9),
    (DEVICE, "track", 3, 10150, 10950, 9),
]
REPLAY = [
    (HOST, "replay_chunk", 1, 0, 3000, 0), (DEVICE, "preprocess", 1, 100, 600, 4),
    (HOST, "step.enqueue", 2, 750, 900, 1), (DEVICE, "step", 2, 800, 1800, 4),
    (HOST, "step.enqueue", 3, 1000, 1200, 1), (DEVICE, "step", 3, 2000, 2500, 5),
]


def _trace(spec, dropped=0):
    us = [(c, n, k, 1000 * a, 1000 * b, x) for c, n, k, a, b, x in spec]
    return assemble(*_records(us), dropped=dropped)


def test_assemble_self_times_and_idle_by_host_span():
    trace = _trace(STREAM)
    step2 = [s for s in trace.named("step") if s.call == 2][0]
    assert step2.self_ns == 1000 * (7000 - 600 - 4000 - 2000)
    assert trace.spans[step2.parent].name == "step.enqueue"
    assert trace.window_ns == (0, 11_100_000) and trace.busy_ns == 1000 * (1000 + 7000 + 1000)
    # idle: 0-100 in step 1's enqueue, 1100-2100 and 9100-10100 in the caller
    assert trace.idle_ns == {"step.enqueue": 100_000, "caller": 2_000_000}
    assert trace.idle_pct == pytest.approx(100 * 2100 / 11100)
    replay = _trace(REPLAY)
    # 0-100, 600-800 and 1800-2000: their middles in replay_chunk and in no
    # step's enqueue
    assert replay.idle_ns == {"replay_chunk": 1000 * (100 + 200 + 200)}
    assert [s.frame for s in replay.named("step.enqueue", HOST)] == [4, 5]
    # a begin without its end (its record dropped) makes no span
    dev, host = _records([(c, n, k, 1000 * a, 1000 * b, x) for c, n, k, a, b, x in STREAM])
    cut = assemble(dev[:-1], host, dropped=1)
    assert len(cut.spans) == len(trace.spans) - 1 and cut.dropped == 1


def _profile_spans():
    spec = importlib.util.spec_from_file_location("profile_spans",
                                                  os.path.join(REPO, "profile_spans.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


READINGS_WANT = {
    # ms and % of the hand-made windows
    "track_device_ms": (STREAM, 0.6),           # median of 0.5, 0.6, 0.8
    "step_enqueue_ms": (STREAM, 0.25),          # cruise steps 1 and 3: 0.3, 0.2
    "stream_idle_pct": (STREAM, 100 * 2100 / 11100),
    "pnp_device_ms": (STREAM, 4.0),
    "kf_prep_device_ms": (STREAM, 1.0),
    "ba_device_ms": (STREAM, 1.0),
    "replay_idle_pct": (REPLAY, 100 * 500 / 2500),
}


@pytest.mark.parametrize("name", sorted(READINGS_WANT))
def test_each_reading_on_a_hand_made_window(name):
    read = _profile_spans().READINGS[name]
    spec, want = READINGS_WANT[name]
    assert read(_trace(spec)) == pytest.approx(want)
    # nothing when a record was dropped, when there is no trace, and when
    # its spans are absent
    assert read(_trace(spec, dropped=1)) is None and read(None) is None
    assert read(_trace([])) is None
    if name in ("pnp_device_ms", "kf_prep_device_ms", "ba_device_ms", "replay_idle_pct",
                "track_device_ms"):
        assert read(_trace(REPLAY if spec is STREAM else STREAM)) is None


def test_profile_spans_refuses_without_the_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert _profile_spans().main([]) == 1


def test_run_vo_and_the_cli_write_spans_json(tmp_path, frames):
    from stereo_vo_tpu_torch.cli import main
    from stereo_vo_tpu_torch.data.stream import StereoFrame
    from stereo_vo_tpu_torch.engine.driver import run_vo

    stream = [StereoFrame(left=l, right=r, stamp=i / 11, index=i)
              for i, (l, r) in enumerate(frames[:6])]
    run = run_vo(stream, _config(), out_dir=str(tmp_path / "a"), chunk_size=2, device="cpu",
                 trace=True)
    with open(tmp_path / "a" / "spans.json") as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e["ph"] == "X"]
    assert len(spans) == len(run.spans.spans) and run.spans.dropped == 0
    assert {e["name"] for e in spans} >= {"bootstrap", "replay_chunk", "preprocess", "step",
                                          "step.enqueue", "track"}
    assert all(e["dur"] >= 0 and e["args"]["self_us"] >= 0 for e in spans)
    with pytest.raises(ValueError):
        run_vo(stream, _config(), device="cpu", trace=True,
               engine=VOEngine(_config(), SHAPE, device="cpu"))
    out = tmp_path / "b"
    assert main(["run", "--config", "kitti00", "--synthetic", "3", "--synthetic-shape", "240",
                 "320", "--device", "cpu", "--quiet", "--trace", "--out", str(out)]) == 0
    with open(out / "spans.json") as f:
        assert any(e.get("name") == "bootstrap" for e in json.load(f)["traceEvents"])


# ---------------------------------------------------------------------------
# on the card

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _keyframe_world(n=12):
    from stereo_vo_tpu_torch.core.config import load_config

    cfg = load_config("kitti00")
    world = SyntheticStereoSequence(cam=cfg.camera, shape=(376, 1241), n_frames=20,
                                    n_points=4000, seed=0, speed=0.8, yaw_rate=0.003)
    return cfg, [world.render(i) for i in range(n)]


@pytest.mark.cuda
def test_cuda_stamps_and_the_device_clock():
    dev = _card()
    ring = torch.zeros((4, 4), dtype=torch.int64, device=dev)
    ctl = torch.zeros(3, dtype=torch.int64, device=dev)
    frame = torch.tensor(17, dtype=torch.int32, device=dev)
    before = profiling.device_stamp.launches
    profiling.device_stamp(ring, ctl, 6, frame, 5)
    for code in (8, 9, 7, 7):
        profiling.device_stamp(ring, ctl, code)
    rows = ring.cpu().tolist()
    assert profiling.device_stamp.launches == before + 5 and int(ctl[0]) == 5
    assert [r[1:] for r in rows] == [[6, 17, 5], [8, 17, 5], [9, 17, 5], [7, 17, 5]]
    assert [r[0] for r in rows] == sorted(r[0] for r in rows)
    tick = profiling.timer_tick(dev)
    assert tick["steps"] > 0 and tick["tick_ns"] > 0 and tick["mean_step_ns"] <= 2000
    rec = Recorder(dev)
    assert 0 < rec.calibration.error_ns < 1_000_000


def _spans_by_frame(trace):
    out = {}
    for s in trace.spans:
        out.setdefault((s.frame, s.call), []).append((s.clock, s.name))
    return {k: sorted(v) for k, v in out.items()}


@pytest.mark.cuda
def test_cuda_ba_spans_count_the_solves_and_graph_equals_eager():
    dev = _card()
    cfg, frames = _keyframe_world()
    traces, programs = {}, {}
    for graph in (True, False):
        engine = VOEngine(cfg, (376, 1241), device=dev, graphs=graph, trace=True)
        state, _ = engine.bootstrap(engine.init_state(), *frames[0])
        state, _ = engine.step(state, *frames[1])      # the capture
        first = engine.trace_records()
        engine.flush_launches()
        if graph:
            program = list(engine.programs.values())[0]
            runs = dict(program.runs)
        for left, right in frames[2:]:
            state, out = engine.step(state, left, right)
        out.summary.cpu()
        engine.flush_launches()
        traces[graph] = (first, engine.trace_records())
        if graph:
            solves = sum(n - runs.get(k, 0) for k, n in program.runs.items()
                         if k == "if:_solve")
            programs[graph] = solves
    first, replays = traces[True]
    assert replays.dropped == 0 and len(replays.named("ba")) == programs[True] >= 8
    assert len(replays.named("kf_prep")) == programs[True]
    for g, e in zip(traces[True], traces[False]):
        assert _spans_by_frame(g) == _spans_by_frame(e)


@pytest.mark.cuda
def test_cuda_device_spans_start_after_their_host_spans():
    dev = _card()
    cfg, frames = _keyframe_world(8)
    engine = VOEngine(cfg, (376, 1241), device=dev, trace=True)
    state, _ = engine.bootstrap(engine.init_state(), *frames[0])
    for left, right in frames[1:]:
        state, out = engine.step(state, left, right)
        out.summary.cpu()
    trace = engine.trace_records()
    tops = [s for s in trace.spans if s.clock == DEVICE and s.name in ("step", "bootstrap")]
    assert len(tops) == len(frames)
    for s in tops:
        host = trace.spans[s.parent]
        assert s.begin_ns >= host.begin_ns - trace.calibration_error_ns, (s, host)
        assert s.end_ns >= host.begin_ns
    for s in trace.spans:
        if s.clock == DEVICE and s.name in LAYERS:
            step = trace.spans[s.parent]
            assert step.begin_ns <= s.begin_ns <= s.end_ns <= step.end_ns


@pytest.mark.cuda
def test_cuda_trace_off_captures_no_stamp():
    dev = _card()
    cfg, frames = _keyframe_world(6)
    seen = {}
    for trace in (False, True):
        engine = VOEngine(cfg, (376, 1241), device=dev, trace=trace)
        stamps = profiling.device_stamp.launches
        state, _ = engine.bootstrap(engine.init_state(), *frames[0])
        engine.flush_launches()
        before = {w.__name__: w.launches for w in graphs.COUNTED}
        for left, right in frames[1:]:
            state, out = engine.step(state, left, right)
        out.summary.cpu()
        engine.flush_launches()
        program = list(engine.programs.values())[0]
        seen[trace] = (program.bodies, program.conds, program.whiles, dict(program.runs),
                       {w.__name__: w.launches - before[w.__name__] for w in graphs.COUNTED},
                       profiling.device_stamp.launches - stamps)
    assert seen[False][5] == 0 and seen[True][5] > 0
    assert seen[False][:5] == seen[True][:5]
