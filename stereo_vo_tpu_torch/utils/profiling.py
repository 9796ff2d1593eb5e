"""Profiling utilities (counterpart of ``stereo_vo_tpu/utils/profiling.py``).

The engine's span recorder (``Recorder``, ``VOEngine(..., trace=True)``),
and a context manager around ``torch.profiler`` for device traces.
``summarize_trace`` sums the profile by kernel name: on a CUDA device, the
self device time of each kernel; on the CPU, where there are no kernels, the
self CPU time of each operator.

The recorder keeps two kinds of span, each named once in ``SPANS``. Host
spans read ``time.perf_counter_ns()`` around an engine call. Device spans
are stamps in the device's stream order: a one-thread kernel
(``csrc/graph_cond.cu``'s ``svo_stamp``) that reads ``%globaltimer`` and
appends a record to a ring on the device, captured into the step graph like
any kernel, inside its IF and WHILE bodies too. Nothing is read back per
frame: ``Recorder.drain`` (``VOEngine.trace_records``) synchronizes, reads
the ring once, maps the device clock onto ``perf_counter_ns()`` (a stamp
between two host reads around a synchronize, the shortest of
``CALIBRATION_SAMPLES`` round trips, at construction and at every drain,
interpolated between the two) and pairs the records into spans, each with
its call, the state's frame index at the call's start, its parent and its
self time, and the device's idle time split by the host span the host was
in. On the CPU a device stamp is a ``perf_counter_ns()`` read, since the
work runs synchronously.

    with device_trace("out/trace") as prof:
        engine.step(state, left, right)
    for ms, name in summarize_trace(prof):
        print(ms, name)

``profile_replay`` profiles a window of streamed steps on the card: kernel
launches, CUDA graph launches, synchronizations and device time per frame,
the device launches of the port's hand-written kernels, each step's runtime
calls and device time, split into cruise and keyframe steps (the device's
busy share of a cruise step among them), step and ``track_step`` latency.
``profile_keyframes`` does the same for keyframe steps (the 20-frame world,
where every frame is a keyframe), with the wrappers' own launch counts
beside the trace's; ``profile_chunk`` for one chunk of ``replay_chunk``
(the runtime calls inside it, the syncs among them); and
``keyframe_bm_input`` builds the 748-slot sparse-BM input of a keyframe
step. ``recorded_solves`` keeps the windows the bundle adjustments of some
steps start from, and ``profile_solves`` replays each of those solves as a
graph program of its own (``solve_program``) and reads its device time and
kernels (``device_profile``, the kernels' sum; ``elapsed_ms``, CUDA events
around the replays) beside the LM loop's stop (``lm_stop``), per LM body
and run eagerly. ``profile_step_parts`` splits an eager keyframe step's
device time and kernels into detection, BM, PnP and BA (in a profiled graph
step a WHILE body nested in an IF body shows its first trip's kernels
only).
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import dataclasses
import json
import os
import statistics
import time
from typing import Dict, List, Optional, Tuple


HOST, DEVICE = "host", "device"

# every span the engine records, named once: (clock, name) -> the span of the
# same call it nests in. A host span nests in the host span of the call that
# made it, if any (``step.enqueue`` inside ``replay_chunk``). PERF.md §3 names
# the metric that reads each one.
SPANS = {
    (HOST, "replay_chunk"): None,                  # the whole call
    (HOST, "step.enqueue"): (HOST, "replay_chunk"),  # VOEngine.step, entry to return
    (HOST, "bootstrap"): None,                     # VOEngine.bootstrap, entry to return
    (DEVICE, "step"): (HOST, "step.enqueue"),      # input copies to the graph's last node
    (DEVICE, "bootstrap"): (HOST, "bootstrap"),    # bootstrap's eager device work
    (DEVICE, "preprocess"): (HOST, "replay_chunk"),  # the chunk's batched preprocessing
    (DEVICE, "track"): (DEVICE, "step"),           # track_step
    (DEVICE, "pnp"): (DEVICE, "step"),             # the PnP body
    (DEVICE, "kf_prep"): (DEVICE, "step"),         # the keyframe-prep body
    (DEVICE, "ba"): (DEVICE, "step"),              # bundle_adjust in the solve body
}
_KEYS = tuple(SPANS)
# a span's record codes: 2 k at its begin, 2 k + 1 at its end
_CODE = {key: 2 * k for k, key in enumerate(_KEYS)}
# device records the ring holds between drains: a 10 s window is about 2,000
# streamed steps or 1,900 replayed frames at about 10 records each
RING_RECORDS = 1 << 17
# calibration round trips at construction and at each drain
CALIBRATION_SAMPLES = 32


@dataclasses.dataclass
class Span:
    """One span on the host clock (``perf_counter_ns()``): ``call`` is the
    engine call it belongs to (``step``, ``bootstrap``, ``replay_chunk``,
    numbered from 1 by the recorder), ``frame`` the state's frame index when
    that call began (-1 where none was given); ``parent`` the index of the
    span it nests in; ``self_ns`` its duration less what its children on
    its own clock cover (the device work a host span enqueued runs on
    another timeline)."""
    clock: str
    name: str
    call: int
    frame: int
    begin_ns: int
    end_ns: int
    parent: Optional[int] = None
    self_ns: int = 0

    @property
    def ms(self) -> float:
        return (self.end_ns - self.begin_ns) / 1e6


@dataclasses.dataclass
class Trace:
    """What ``Recorder.drain`` returns: the spans in order of their begin,
    the device records the ring had no slot for, the window (the first host
    span's begin to the last device span's end), the device's busy time in
    it (the union of the device spans that nest in no device span: ``step``,
    ``bootstrap``, ``preprocess``) and its idle time, by the innermost
    host span the host was in at each gap's middle or ``caller`` where it
    was in none, and the calibration's error (half its round trip; 0 on the
    CPU)."""
    spans: List[Span]
    dropped: int = 0
    window_ns: Tuple[int, int] = (0, 0)
    busy_ns: int = 0
    idle_ns: Dict[str, int] = dataclasses.field(default_factory=dict)
    calibration_error_ns: int = 0

    def named(self, name: str, clock: str = DEVICE) -> List[Span]:
        return [s for s in self.spans if s.name == name and s.clock == clock]

    @property
    def idle_pct(self) -> Optional[float]:
        """100 x the window's share outside the device spans."""
        width = self.window_ns[1] - self.window_ns[0]
        return 100.0 * (width - self.busy_ns) / width if width > 0 else None


@dataclasses.dataclass
class Calibration:
    """A device clock reading and the host clock at the same moment, within
    ``error_ns``."""
    device_ns: int
    host_ns: int
    error_ns: int


_stamp_fn = None


def device_stamp(ring, ctl, code: int, frame=None, call: int = -1) -> None:
    """One stamp kernel on the current stream (``svo_stamp``), a kernel node
    when the stream captures; ``call`` >= 0 opens a call with ``frame`` (a
    0-d int32 tensor on the device, or None). Counted in
    ``device_stamp.launches``. A streamed step makes two on the host, so the
    library's function is looked up once and the stream is read raw."""
    global _stamp_fn
    import torch

    if _stamp_fn is None:
        from stereo_vo_tpu_torch.engine.graphs import cond_lib

        _stamp_fn = cond_lib().stamp
    rc = _stamp_fn(torch._C._cuda_getCurrentRawStream(ring.device.index), ring.data_ptr(),
                   ctl.data_ptr(), ring.shape[0], code,
                   None if frame is None else frame.data_ptr(), call)
    if rc != 0:
        raise RuntimeError(f"device stamp failed: CUDA error {rc}")
    device_stamp.launches += 1


device_stamp.launches = 0


def timer_tick(device, reads: int = 1 << 16) -> Dict[str, float]:
    """The resolution of the device clock the stamps read (``%globaltimer``)
    on a CUDA ``device``: one thread reads it ``reads`` times; ``tick_ns``
    the smallest step between two readings that differ, ``mean_step_ns``
    the mean one, ``steps`` how many it saw."""
    import torch

    from stereo_vo_tpu_torch.engine.graphs import _raise_on, cond_lib

    out = torch.zeros(3, dtype=torch.int64, device=device)
    stream = torch.cuda.current_stream(out.device)
    _raise_on(cond_lib().tick(stream.cuda_stream, out.data_ptr(), reads), "timer tick")
    best, steps, elapsed = out.tolist()
    return {"tick_ns": best, "steps": steps, "mean_step_ns": elapsed / steps if steps else 0.0}


class Recorder:
    """The spans of one engine (module docstring). ``call`` runs an engine
    call inside its host span and, given a device span, inside that too,
    opened with the call's number and frame; ``span`` is a device span
    inside the call running now; ``drain`` returns the spans since the last
    drain. On a CUDA device the ring holds ``capacity`` records; on the CPU
    as many are kept. Records past it are counted as dropped."""

    def __init__(self, device, capacity: int = RING_RECORDS):
        import torch

        from stereo_vo_tpu_torch.engine.graphs import discarding

        self.device = torch.device(device)
        self.capacity = int(capacity)
        self.on_card = self.device.type == "cuda"
        self._discarding = discarding
        self._calls = 0
        self._open: List[int] = []        # the calls running on the host
        self._host: List[tuple] = []      # (ns, code, call, parent call)
        if self.on_card:
            def zeros(*shape):
                return torch.zeros(shape, dtype=torch.int64, device=self.device)

            # ctl: the next slot, the open call, its frame
            self._ring, self._ctl = zeros(self.capacity, 4), zeros(3)
            self._cal_ring, self._cal_ctl = zeros(CALIBRATION_SAMPLES, 4), zeros(3)
            self.calibration = self._calibrate()
        else:
            self._records: List[tuple] = []   # (ns, code, frame, call)
            self._made = 0
            self._current = (-1, 0)

    # ------------------------------------------------------------------
    def call(self, host: str, device: Optional[str], frame, fn, *args):
        """``fn(*args)`` inside the host span ``host`` and, given ``device``,
        the device span ``device`` opened with this call's number and
        ``frame`` (the state's 0-d frame index)."""
        self._calls += 1
        call = self._calls
        parent = self._open[-1] if self._open else 0
        code = _CODE[(HOST, host)]
        self._host.append((time.perf_counter_ns(), code, call, parent))
        self._open.append(call)
        try:
            if device is None:
                out = fn(*args)
            else:
                with self.span(device, frame):
                    out = fn(*args)
        finally:
            self._open.pop()
        self._host.append((time.perf_counter_ns(), code + 1, call, parent))
        return out

    @contextlib.contextmanager
    def span(self, device: str, frame=None):
        """The device span ``device`` around the work enqueued inside the
        block; given ``frame``, it opens the running call's number and that
        frame for the stamps after it (captured ones among them)."""
        code = _CODE[(DEVICE, device)]
        if frame is None:
            self._stamp(code)
        else:
            self._stamp(code, frame, self._open[-1] if self._open else 0)
        yield
        self._stamp(code + 1)

    def _stamp(self, code: int, frame=None, call: int = -1) -> None:
        if self._discarding():
            return
        if self.on_card:
            device_stamp(self._ring, self._ctl, code, frame, call)
            return
        if call >= 0:
            self._current = (int(frame) if frame is not None else -1, call)
        self._made += 1
        if self._made <= self.capacity:
            self._records.append((time.perf_counter_ns(), code, *self._current))

    # ------------------------------------------------------------------
    def drain(self) -> Trace:
        """The spans recorded since the last drain (``Trace``), on the host
        clock; between calls only. On the card: one synchronize, one read of
        the ring, the cursor reset, a new calibration."""
        if self._open:
            raise RuntimeError("drain between the engine's calls, not inside one")
        host, self._host = self._host, []
        if not self.on_card:
            records, self._records = self._records, []
            made, self._made = self._made, 0
            return assemble(records, host, dropped=max(made - self.capacity, 0))
        import torch

        torch.cuda.synchronize(self.device)
        made = int(self._ctl[0])
        rows = self._ring[:min(made, self.capacity)].cpu().numpy()
        self._ctl[:1].zero_()
        before, self.calibration = self.calibration, self._calibrate()
        rows[:, 0] = _to_host(rows[:, 0], before, self.calibration)
        return assemble(rows.tolist(), host, dropped=max(made - self.capacity, 0),
                        calibration_error_ns=max(before.error_ns, self.calibration.error_ns))

    def _calibrate(self) -> Calibration:
        """A stamp between two host reads around a synchronize, repeated:
        the sample with the shortest round trip, its device reading against
        the middle of its host reads."""
        import torch

        self._cal_ctl.zero_()
        rounds = []
        for _ in range(CALIBRATION_SAMPLES):
            torch.cuda.synchronize(self.device)
            h0 = time.perf_counter_ns()
            device_stamp(self._cal_ring, self._cal_ctl, 0)
            torch.cuda.synchronize(self.device)
            rounds.append((h0, time.perf_counter_ns()))
        device_ns = self._cal_ring[:, 0].tolist()
        k = min(range(len(rounds)), key=lambda i: rounds[i][1] - rounds[i][0])
        h0, h1 = rounds[k]
        return Calibration(device_ns[k], (h0 + h1) // 2, (h1 - h0 + 1) // 2)


def _to_host(ns, a: Calibration, b: Calibration):
    """Device readings ``ns`` (an int64 array) on the host clock: the offset
    interpolated between calibrations ``a`` and ``b`` by device time (held at
    the nearer one outside them)."""
    import numpy as np

    off_a, off_b = a.host_ns - a.device_ns, b.host_ns - b.device_ns
    width = b.device_ns - a.device_ns
    if width <= 0:
        return ns + off_b
    w = np.clip((ns - a.device_ns) / width, 0.0, 1.0)
    return ns + np.round(off_a + (off_b - off_a) * w).astype(np.int64)


def _covered(begin: int, end: int, intervals) -> int:
    """The length of ``[begin, end]`` that the union of ``intervals`` covers."""
    return sum(b - a for a, b in _merged((max(a, begin), min(b, end)) for a, b in intervals
                                         if b > begin and a < end))


def _merged(intervals) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def assemble(device_records, host_records, dropped: int = 0,
             calibration_error_ns: int = 0) -> Trace:
    """A ``Trace`` from records on the host clock: ``device_records`` rows
    ``(ns, code, frame, call)``, ``host_records`` rows ``(ns, code, call,
    parent call)`` (0: none). A begin whose end is missing (a record
    dropped) makes no span."""
    opened: Dict[tuple, tuple] = {}
    raw = []
    for rows, clock in ((device_records, DEVICE), (host_records, HOST)):
        for ns, code, a, b in rows:
            name = _KEYS[code // 2][1]
            key = (clock, name, a if clock == HOST else b)
            if code % 2 == 0:
                opened[key] = (ns, a, b)
                continue
            start = opened.pop(key, None)
            if start is None:
                continue
            t0, a0, b0 = start
            if clock == DEVICE:
                raw.append((t0, ns, clock, name, b0, a0, SPANS[(clock, name)]))
            else:
                raw.append((t0, ns, clock, name, a0, -1, b0))
    raw.sort(key=lambda r: (r[0], r[2] == DEVICE))
    frames: Dict[int, int] = {}
    for r in raw:
        if r[2] == DEVICE and r[5] >= 0:
            frames.setdefault(r[4], r[5])
    spans = [Span(clock, name, call, frame if clock == DEVICE else frames.get(call, -1), t0, t1)
             for t0, t1, clock, name, call, frame, _ in raw]
    index = {(s.clock, s.name, s.call): k for k, s in enumerate(spans)}
    host_call = {s.call: k for k, s in enumerate(spans) if s.clock == HOST}
    children: List[List[int]] = [[] for _ in spans]
    for k, (s, r) in enumerate(zip(spans, raw)):
        up = r[6]
        s.parent = (host_call.get(up) if s.clock == HOST
                    else None if up is None else index.get((*up, s.call)))
        if s.parent is not None and spans[s.parent].clock == s.clock:
            children[s.parent].append(k)
    for s, kids in zip(spans, children):
        s.self_ns = s.end_ns - s.begin_ns - _covered(
            s.begin_ns, s.end_ns, [(spans[j].begin_ns, spans[j].end_ns) for j in kids])
    trace = Trace(spans, dropped=dropped, calibration_error_ns=calibration_error_ns)
    _idle(trace)
    return trace


def _idle(trace: Trace) -> None:
    """The window, the device's busy time and its idle time by host span
    (``Trace``'s fields), from the spans."""
    spans = trace.spans
    device = [(s.begin_ns, s.end_ns) for s in spans if s.clock == DEVICE
              and (s.parent is None or spans[s.parent].clock == HOST)]
    host = [s for s in spans if s.clock == HOST]
    if not device:
        return
    t0 = min(s.begin_ns for s in host) if host else min(a for a, _ in device)
    t1 = max(b for _, b in device)
    busy = _merged((max(a, t0), min(b, t1)) for a, b in device if b > t0 and a < t1)
    trace.window_ns, trace.busy_ns = (t0, t1), sum(b - a for a, b in busy)
    starts = [s.begin_ns for s in host]
    idle: Dict[str, int] = collections.Counter()
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) // 2
        where = "caller"
        # the innermost host span around the middle: the latest to begin,
        # looked for among the spans of the outermost one begun before it
        for k in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
            if host[k].begin_ns <= mid < host[k].end_ns:
                where = host[k].name
                break
            if host[k].parent is None:
                break
        idle[where] += b - a
    trace.idle_ns = dict(idle)


def write_chrome_trace(trace: Trace, path: str) -> None:
    """``trace`` to ``path`` in the Chrome trace format (``chrome://tracing``,
    ``ui.perfetto.dev``): one complete event per span, microseconds from the
    first span, host spans on one track and device spans on another, each
    with its call, frame, parent and self time; ``otherData`` holds the
    records dropped and the device's idle time by host span."""
    t0 = min((s.begin_ns for s in trace.spans), default=0)
    tracks = {HOST: 1, DEVICE: 2}
    events = [{"ph": "M", "name": "thread_name", "pid": 1, "tid": tid, "args": {"name": clock}}
              for clock, tid in tracks.items()]
    for k, s in enumerate(trace.spans):
        events.append({"ph": "X", "name": s.name, "pid": 1, "tid": tracks[s.clock],
                       "ts": (s.begin_ns - t0) / 1e3, "dur": (s.end_ns - s.begin_ns) / 1e3,
                       "args": {"span": k, "call": s.call, "frame": s.frame,
                                "parent": s.parent, "self_us": s.self_ns / 1e3}})
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms",
                   "otherData": {"dropped": trace.dropped, "idle_ns": trace.idle_ns,
                                 "calibration_error_ns": trace.calibration_error_ns}}, f)


@contextlib.contextmanager
def device_trace(out_dir: Optional[str] = None):
    """Profile a block with ``torch.profiler`` (CPU, plus CUDA when a device
    is present) and yield the profiler. With ``out_dir``, the Chrome trace is
    written to ``out_dir/trace.json`` when the block ends."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))


def summarize_trace(prof, top: int = 20) -> List[Tuple[float, str]]:
    """``[(total_ms, kernel name), ...]`` sorted descending: device kernels
    by self device time when the profile saw any, else CPU operators by self
    CPU time. A ``record_function`` range also appears on the device's
    timeline, spanning the kernels inside it; it is no kernel and is left
    out."""
    from torch.autograd import DeviceType

    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False) and e.key not in RANGES]
    if kernels:
        times = ((e.key, e.self_device_time_total) for e in kernels)
    else:
        times = ((e.key, e.self_cpu_time_total) for e in events)
    by_name = collections.Counter()
    for name, us in times:
        by_name[name] += us
    return [(round(us / 1000, 3), name) for name, us in by_name.most_common(top) if us > 0]


_KERNEL_LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                        "cuLaunchKernelEx")
_GRAPH_LAUNCH_CALLS = ("cudaGraphLaunch", "cuGraphLaunch")


def runtime_calls(prof) -> Dict[str, int]:
    """Host-side CUDA runtime calls in a profile: ``launches`` (kernel
    launches), ``graph_launches`` (CUDA graph replays) and ``syncs`` (calls
    that wait for the device)."""
    calls = {"launches": 0, "graph_launches": 0, "syncs": 0}
    for e in prof.key_averages():
        if e.key in _KERNEL_LAUNCH_CALLS:
            calls["launches"] += e.count
        elif e.key in _GRAPH_LAUNCH_CALLS:
            calls["graph_launches"] += e.count
        elif "Synchronize" in e.key:
            calls["syncs"] += e.count
    return calls


def range_calls(prof, name: str) -> List[Dict[str, float]]:
    """For each ``record_function(name)`` range in a profile, in order, the
    runtime calls inside it (``syncs``, ``launches``, ``graph_launches`` and
    ``copies``, host-side events only: the profiler also draws each range on
    the device's timeline), its host wall ``wall_ms``, and the number and
    device time of the kernels that started inside it, ``kernels`` and
    ``device_ms``."""
    import bisect

    from torch.autograd import DeviceType

    events = prof.events()
    host = sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                  if e.device_type == DeviceType.CPU)
    kernels = sorted((e.time_range.start, e.time_range.end) for e in events
                     if e.device_type == DeviceType.CUDA and e.name not in RANGES
                     and not getattr(e, "is_user_annotation", False))
    host_starts = [h[0] for h in host]
    kernel_starts = [k[0] for k in kernels]
    out = []
    for start, end, _ in (h for h in host if h[2] == name):
        calls = {"syncs": 0, "launches": 0, "graph_launches": 0, "copies": 0,
                 "wall_ms": (end - start) / 1e3, "kernels": 0, "device_ms": 0.0}
        lo, hi = bisect.bisect_left(host_starts, start), bisect.bisect_right(host_starts, end)
        for _, e_end, e_name in host[lo:hi]:
            if e_end > end:
                continue
            if "Synchronize" in e_name:
                calls["syncs"] += 1
            elif e_name in _KERNEL_LAUNCH_CALLS:
                calls["launches"] += 1
            elif e_name in _GRAPH_LAUNCH_CALLS:
                calls["graph_launches"] += 1
            elif e_name.startswith("cudaMemcpy"):
                calls["copies"] += 1
        lo, hi = bisect.bisect_left(kernel_starts, start), bisect.bisect_left(kernel_starts, end)
        calls["kernels"] = hi - lo
        calls["device_ms"] = sum(k_end - k_start for k_start, k_end in kernels[lo:hi]) / 1e3
        out.append(calls)
    return out


def _mean_calls(rows) -> Optional[Dict[str, float]]:
    """The mean of ``range_calls`` rows, with the device's busy share (device
    ms over wall ms) and their count; ``None`` for no row."""
    if not rows:
        return None
    keys = ("syncs", "launches", "graph_launches", "copies", "wall_ms", "kernels", "device_ms")
    mean = {k: sum(r[k] for r in rows) / len(rows) for k in keys}
    mean["busy_share"] = mean["device_ms"] / mean["wall_ms"] if mean["wall_ms"] > 0 else 0.0
    mean["steps"] = len(rows)
    return mean


# PERF.md section 5 profiles the steps of frames PROFILED_FRAMES[0] ..
# PROFILED_FRAMES[1] - 1 of a streamed replay and times the unprofiled steps of
# CRUISE_FRAMES around them (frames 65-72 and 49-80: hinted cruise frames of
# the 129-frame synthetic world)
PROFILED_FRAMES = (65, 73)
CRUISE_FRAMES = (49, 81)

# the steps of the 20-frame synthetic world (every frame a keyframe) that
# profile_keyframes profiles, and the first unprofiled step it times (step 1
# builds the LK kernel at first use)
KEYFRAME_PROFILED = (8, 12)
KEYFRAME_TIMED_FROM = 2

# device function names of the port's hand-written kernels (csrc/*.cu), and
# the wrapper that counts each one's launches: (module, function)
PORT_KERNELS = ("lk_level_kernel", "stereo_bm_at_kernel", "extract_regions_kernel",
                "greedy_nms_kernel", "ba_build_kernel", "ba_damp_reduce_kernel",
                "ba_step_kernel", "ba_cost_kernel", "pnp_hyp_kernel")
PORT_WRAPPERS = {"lk_level_kernel": ("ops.lk", "lk_level_pass"),
                 "stereo_bm_at_kernel": ("ops.stereo_bm", "stereo_bm_at"),
                 "extract_regions_kernel": ("ops.regions", "extract_regions"),
                 "greedy_nms_kernel": ("ops.shi_tomasi", "greedy_nms"),
                 "ba_build_kernel": ("backend.schur", "ba_build"),
                 "ba_damp_reduce_kernel": ("backend.schur", "ba_damp_reduce"),
                 "ba_step_kernel": ("backend.schur", "ba_step"),
                 "ba_cost_kernel": ("backend.schur", "ba_cost"),
                 "pnp_hyp_kernel": ("frontend.pnp", "pnp_hypotheses")}
# the profiler ranges this module puts around each profiled step (the step
# call and the summary fetch) and around each profiled replay_chunk call, and
# the one replay_chunk puts around its frames (engine/step.py CHUNK_RANGE)
STEP_RANGE = "profile.step"
CHUNK_CALL_RANGE = "profile.replay_chunk"
CHUNK_RANGE = "VOEngine.replay_chunk.frames"
# the parts of a keyframe step that profile_step_parts puts in ranges
# ("part.<name>"): the functions engine/step.py calls for them
STEP_PARTS = {"detect": "detect_features", "bm": "stereo_bm_at", "pnp": "pnp_ransac",
              "ba": "bundle_adjust"}
RANGES = (STEP_RANGE, CHUNK_CALL_RANGE, CHUNK_RANGE) + tuple("part." + p for p in STEP_PARTS)


def wrapper_launches() -> Dict[str, int]:
    """The launch count of each of ``PORT_KERNELS``' wrappers, by kernel
    name, in the ``stereo_vo_tpu_torch`` on ``sys.path`` (0 where that
    package has no such wrapper)."""
    import importlib

    out = {}
    for kernel, (module, fn) in PORT_WRAPPERS.items():
        wrapper = getattr(importlib.import_module("stereo_vo_tpu_torch." + module), fn, None)
        out[kernel] = getattr(wrapper, "launches", 0)
    return out


def _trace_counts(prof, n, counted=None, keyframes=None) -> dict:
    """Launches, CUDA graph launches, syncs and device ms per step over ``n``
    profiled steps, the device launches of each of ``PORT_KERNELS`` in the
    trace and, given ``counted`` (the wrappers' launch counts over the same
    steps), those beside them; and each step's own calls (``STEP_RANGE``),
    with their means over the cruise and the keyframe steps given
    ``keyframes`` (one flag per step)."""
    from torch.autograd import DeviceType

    calls = runtime_calls(prof)
    device_ms = sum(ms for ms, _ in summarize_trace(prof, top=100000))
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    out = {
        "launches_per_frame": calls["launches"] / n,
        "graph_launches_per_frame": calls["graph_launches"] / n,
        "syncs_per_frame": calls["syncs"] / n,
        "device_ms_per_frame": device_ms / n,
        "kernel_launches": {name: sum(e.count for e in kernels if name in e.key)
                            for name in PORT_KERNELS},
        "steps": range_calls(prof, STEP_RANGE),
    }
    if keyframes is not None and len(keyframes) == len(out["steps"]):
        out["cruise_step"] = _mean_calls([r for r, kf in zip(out["steps"], keyframes)
                                          if not kf])
        out["keyframe_step"] = _mean_calls([r for r, kf in zip(out["steps"], keyframes) if kf])
    if counted is not None:
        out["wrapper_launches"] = counted
    return out


def _step(engine, state, f):
    """One streamed step and its summary fetch (the step's one wait for the
    device), inside ``STEP_RANGE``: ``(state, summary vector on the host,
    summary row)``."""
    from torch.profiler import record_function

    from stereo_vo_tpu_torch.engine.step import parse_summary

    with record_function(STEP_RANGE):
        state, out = engine.step(state, f.left, f.right)
        vec = out.summary.cpu().numpy()
    return state, vec, parse_summary(vec)[1]


def _flush(engine) -> None:
    """The engine's device-side launch counts into the wrappers' (an engine
    of a tree that has none reads nothing)."""
    flush = getattr(engine, "flush_launches", None)
    if flush is not None:
        flush()


def profile_replay(cfg, frames, device) -> dict:
    """Stream ``frames`` (``StereoFrame``s, at least ``CRUISE_FRAMES[1]``)
    through a fresh ``VOEngine`` on ``device`` (a CUDA device) and profile
    the steps of ``PROFILED_FRAMES`` with ``torch.profiler``.

    Returns per-frame ``launches``, ``graph_launches``, ``syncs`` and
    ``device_ms`` over the profiled frames, the device launches there of each
    of ``PORT_KERNELS`` (read from the trace, not from the wrappers'
    counters), each profiled step's calls, wall and device ms with their
    means over its cruise and keyframe steps, and, over the unprofiled steps
    of ``CRUISE_FRAMES``, the step wall p50 (from the call to its summary on
    the host) and, afterwards, the p50 of one synchronized ``track_step``
    from each of those steps' tracker states (its result discarded), both in
    ms."""
    import torch

    from stereo_vo_tpu_torch.engine.step import VOEngine
    from stereo_vo_tpu_torch.frontend.track import track_step
    from stereo_vo_tpu_torch.ops.pyramid import build_pyramid

    engine = VOEngine(cfg, frames[0].left.shape, device=device)
    state, _ = engine.bootstrap(engine.init_state(), frames[0].left, frames[0].right)
    step_ms, hinted, keyframes, trackers = [], [], [], []

    def clone(tracker):
        return type(tracker)(*[tuple(x.clone() for x in v) if isinstance(v, tuple) else v.clone()
                               for v in tracker])

    def advance(state, i, timed):
        if timed:
            trackers.append((clone(state.tracker), i))
        t0 = time.perf_counter()
        state, _, row = _step(engine, state, frames[i])
        if timed:
            step_ms.append(1e3 * (time.perf_counter() - t0))
            hinted.append(row["hinted"])
        return state, row

    first, end = PROFILED_FRAMES
    for i in range(1, first):
        state, _ = advance(state, i, i >= CRUISE_FRAMES[0])
    with device_trace() as prof:
        for i in range(first, end):
            state, row = advance(state, i, False)
            keyframes.append(row["is_keyframe"])
    for i in range(end, CRUISE_FRAMES[1]):
        state, _ = advance(state, i, True)
    _flush(engine)
    track_ms = []
    for tracker, i in trackers:
        pyr = build_pyramid(engine._image(frames[i].left), cfg.frontend.lk_max_level)
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        track_step(tracker, tuple(pyr), cfg.frontend)
        torch.cuda.synchronize(device)
        track_ms.append(1e3 * (time.perf_counter() - t0))
    return {
        "frames": [first, end],
        **_trace_counts(prof, end - first, keyframes=keyframes),
        "step_ms_p50": statistics.median(step_ms),
        "track_step_ms_p50": statistics.median(track_ms),
        "hinted_share": sum(hinted) / len(hinted),
    }


def profile_keyframes(cfg, frames, device) -> dict:
    """Stream ``frames`` (the 20-frame synthetic world, every frame a
    keyframe) through a fresh ``VOEngine`` on ``device`` (a CUDA device) and
    profile the steps of ``KEYFRAME_PROFILED`` with ``torch.profiler``.

    Returns the step wall p50 in ms over the unprofiled steps from
    ``KEYFRAME_TIMED_FROM`` on, then per profiled step ``launches``,
    ``graph_launches``, ``syncs`` and ``device_ms``, the device launches
    there of each of ``PORT_KERNELS`` from the trace and from the wrappers'
    counts (``wrapper_launches``), each profiled step's calls, wall and
    device ms with their means, and how many of the profiled steps were
    keyframes."""
    import torch

    from stereo_vo_tpu_torch.engine.step import VOEngine

    engine = VOEngine(cfg, frames[0].left.shape, device=device)
    state, _ = engine.bootstrap(engine.init_state(), frames[0].left, frames[0].right)
    torch.cuda.synchronize(device)
    first, end = KEYFRAME_PROFILED
    step_ms, keyframes = [], []

    for i in range(1, first):
        t0 = time.perf_counter()
        state, _, _ = _step(engine, state, frames[i])
        if i >= KEYFRAME_TIMED_FROM:
            step_ms.append(1e3 * (time.perf_counter() - t0))
    _flush(engine)
    before = wrapper_launches()
    with device_trace() as prof:
        for i in range(first, end):
            state, _, row = _step(engine, state, frames[i])
            keyframes.append(row["is_keyframe"])
    _flush(engine)
    after = wrapper_launches()
    for i in range(end, len(frames)):
        t0 = time.perf_counter()
        state, _, _ = _step(engine, state, frames[i])
        step_ms.append(1e3 * (time.perf_counter() - t0))
    counted = {k: after[k] - before[k] for k in PORT_KERNELS}
    return {
        "frames": [first, end],
        "step_ms_p50": statistics.median(step_ms),
        "keyframes_profiled": sum(keyframes),
        **_trace_counts(prof, end - first, counted, keyframes),
    }


def profile_chunk(cfg, frames, chunk, device) -> dict:
    """Bootstrap a fresh ``VOEngine`` on ``device`` (a CUDA device) on
    ``frames[0]``, run ``replay_chunk`` over frames ``1 .. chunk`` (the
    program's capture), then profile it over the next ``chunk`` frames, the
    images already on the device, as the driver's preload holds them.

    Returns the runtime calls inside that ``replay_chunk`` call (syncs
    among them), its wall and device ms with the busy share, the same per
    frame, each of ``PORT_KERNELS``' launches in the trace, and the
    keyframes among its frames."""
    import numpy as np
    import torch

    from stereo_vo_tpu_torch.engine.step import VOEngine
    from torch.profiler import record_function

    engine = VOEngine(cfg, frames[0].left.shape, device=device)
    state, _ = engine.bootstrap(engine.init_state(), frames[0].left, frames[0].right)
    lefts = torch.from_numpy(np.stack([f.left for f in frames[1:2 * chunk + 1]])).to(device)
    rights = torch.from_numpy(np.stack([f.right for f in frames[1:2 * chunk + 1]])).to(device)
    state, _, _ = engine.replay_chunk(state, lefts[:chunk], rights[:chunk])
    torch.cuda.synchronize(device)
    with device_trace() as prof:
        with record_function(CHUNK_CALL_RANGE):
            state, _, summaries = engine.replay_chunk(state, lefts[chunk:], rights[chunk:])
        rows = summaries.cpu().numpy()
    _flush(engine)
    call = range_calls(prof, CHUNK_CALL_RANGE)[0]
    frames_range = range_calls(prof, CHUNK_RANGE)
    from torch.autograd import DeviceType

    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return {
        "frames": [chunk + 1, 2 * chunk + 1],
        "keyframes": int(rows[:, 7].sum()),
        "call": {**call, "busy_share": call["device_ms"] / call["wall_ms"]},
        "between_frames": frames_range[0] if frames_range else None,
        "per_frame": {k: call[k] / chunk for k in ("syncs", "launches", "graph_launches",
                                                    "copies", "wall_ms", "device_ms")},
        "kernel_launches": {name: sum(e.count for e in kernels if name in e.key)
                            for name in PORT_KERNELS},
    }


def recorded_solves(cfg, frames, device, steps) -> list:
    """Stream ``frames`` eagerly (``graphs=False``) through a fresh
    ``VOEngine`` on ``device`` up to the last of ``steps`` and return, for
    each keyframe step among ``steps``, ``(window, compact)``: the window
    its bundle adjustment starts from and the compaction choice it took."""
    from stereo_vo_tpu_torch.engine import step as step_module
    from stereo_vo_tpu_torch.engine.step import VOEngine

    engine = VOEngine(cfg, frames[0].left.shape, device=device, graphs=False)
    state, _ = engine.bootstrap(engine.init_state(), frames[0].left, frames[0].right)
    windows, solve = [], step_module.bundle_adjust

    def recording(window, cam, bcfg, compact=None):
        windows.append((window, compact))
        return solve(window, cam, bcfg, compact=compact)

    for i in range(1, max(steps) + 1):
        step_module.bundle_adjust = recording if i in steps else solve
        try:
            state, _ = engine.step(state, frames[i].left, frames[i].right)
        finally:
            step_module.bundle_adjust = solve
    return windows


def solve_program(window, cam, bcfg, compact):
    """``bundle_adjust(window, ..., compact=compact)`` as a graph program of
    its own: returns a call that replays it (its first call runs it eagerly
    and captures it)."""
    from stereo_vo_tpu_torch.backend.schur import bundle_adjust
    from stereo_vo_tpu_torch.engine.graphs import Program

    program = Program("solve", lambda carry, inputs: (
        (), bundle_adjust(inputs[0], cam, bcfg, compact=compact)))
    return lambda: program((), (window,))


def device_profile(fn, calls: int = 3) -> Tuple[float, float]:
    """Device time in ms and device kernels per call of ``fn``: every
    kernel's self device time, and the kernels, that ``torch.profiler``
    records over ``calls`` calls, after one unprofiled call."""
    import torch
    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    with device_trace() as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    return (sum(e.self_device_time_total for e in events) / calls / 1e3,
            sum(e.count for e in events) / calls)


def device_ms(fn, calls: int = 3) -> float:
    """Device time per call of ``fn`` in ms (``device_profile``)."""
    return device_profile(fn, calls)[0]


def elapsed_ms(fn, calls: int = 10) -> float:
    """Time per call of ``fn`` on the device's clock in ms: CUDA events
    around ``calls`` calls, after one untimed call (for a graph replay that
    outlasts its launch, the replay's device time with its gaps)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def lm_stop(window, cam, bcfg, compact) -> Tuple[int, int]:
    """``(it, accepted)`` of the LM loop of ``bundle_adjust(window)``, run
    eagerly: the bodies that updated and the accepted steps."""
    from stereo_vo_tpu_torch.backend import schur

    stops, run = [], schur._lm_run

    def recording(*args, **kwargs):
        out = run(*args, **kwargs)
        stops.append((int(out[7]), int(out[4])))
        return out

    schur._lm_run = recording
    try:
        schur.bundle_adjust(window, cam, bcfg, compact=compact)
    finally:
        schur._lm_run = run
    return stops[0]


def profile_solves(cfg, frames, device, steps=range(8, 12)) -> dict:
    """The bundle adjustments of keyframe ``steps`` of ``frames`` (the
    20-frame world: every step a keyframe), each from its recorded window
    (``recorded_solves``) replayed as its own graph program: per solve its
    compaction choice, the LM loop's ``it`` and accepted steps, its device
    ms and device kernels (``device_profile``), its elapsed ms (CUDA events
    around the replays), the same solve with ``max_lm_iters = 0`` (no LM
    body: what surrounds the loop), and from the two the device kernels and
    ms per LM body (the loop runs ``2 * ceil(it / 2)`` bodies, each with its
    rebuild or keep); the same solve run eagerly (``eager_device_ms``: the
    same kernels launched one by one, none in a conditional body); and
    their means."""
    import dataclasses

    from stereo_vo_tpu_torch.backend.schur import bundle_adjust

    rows = []
    for window, compact in recorded_solves(cfg, frames, device, steps):
        it, accepted = lm_stop(window, cfg.camera, cfg.backend, compact)
        call = solve_program(window, cfg.camera, cfg.backend, compact)
        ms, kernels = device_profile(call)
        ms0, kernels0 = device_profile(solve_program(
            window, cfg.camera, dataclasses.replace(cfg.backend, max_lm_iters=0), compact))
        eager_ms, eager_kernels = device_profile(
            lambda: bundle_adjust(window, cfg.camera, cfg.backend, compact=compact))
        bodies = 2 * ((it + 1) // 2)
        rows.append({"compact": compact, "it": it, "accepted": accepted, "bodies": bodies,
                     "device_ms": ms, "device_kernels": kernels, "elapsed_ms": elapsed_ms(call),
                     "loop_free_device_ms": ms0, "loop_free_device_kernels": kernels0,
                     "device_kernels_per_body": (kernels - kernels0) / bodies,
                     "device_ms_per_body": (ms - ms0) / bodies,
                     "eager_device_ms": eager_ms, "eager_device_kernels": eager_kernels})
    return {"steps": [min(steps), max(steps)], "solves": rows,
            **{f"{key}_mean": statistics.mean(r[key] for r in rows)
               for key in ("device_ms", "elapsed_ms", "device_kernels",
                           "device_kernels_per_body", "device_ms_per_body", "eager_device_ms")}}


def profile_step_parts(cfg, frames, device) -> dict:
    """Stream ``frames`` (the 20-frame world, every frame a keyframe) through
    a fresh eager ``VOEngine`` (``graphs=False``: every ``cond`` runs the
    side it takes, so each part's kernels are its own) on ``device`` and
    profile the steps of ``KEYFRAME_PROFILED``, each call of the functions
    of ``STEP_PARTS`` inside a range of its part's name: per keyframe step
    the mean device ms and device kernels of each part and of the whole step
    (its summary fetch included), and the rest."""
    from torch.profiler import record_function

    from stereo_vo_tpu_torch.engine import step as step_module
    from stereo_vo_tpu_torch.engine.step import VOEngine

    def ranged(name, fn):
        def call(*args, **kwargs):
            with record_function(name):
                return fn(*args, **kwargs)
        return call

    engine = VOEngine(cfg, frames[0].left.shape, device=device, graphs=False)
    state, _ = engine.bootstrap(engine.init_state(), frames[0].left, frames[0].right)
    first, end = KEYFRAME_PROFILED
    for i in range(1, first):
        state, _, _ = _step(engine, state, frames[i])
    originals = {fn: getattr(step_module, fn) for fn in STEP_PARTS.values()}
    keyframes = []
    try:
        for part, fn in STEP_PARTS.items():
            setattr(step_module, fn, ranged("part." + part, originals[fn]))
        with device_trace() as prof:
            for i in range(first, end):
                state, _, row = _step(engine, state, frames[i])
                keyframes.append(row["is_keyframe"])
    finally:
        for fn, original in originals.items():
            setattr(step_module, fn, original)
    n = sum(keyframes)
    steps = [r for r, kf in zip(range_calls(prof, STEP_RANGE), keyframes) if kf]
    out = {"frames": [first, end], "keyframe_steps": n,
           "step": {k: sum(r[k] for r in steps) / n for k in ("device_ms", "kernels")}}
    for part in STEP_PARTS:
        rows = range_calls(prof, "part." + part)
        out[part] = {k: sum(r[k] for r in rows) / n for k in ("device_ms", "kernels")}
    out["rest"] = {k: out["step"][k] - sum(out[p][k] for p in STEP_PARTS)
                   for k in ("device_ms", "kernels")}
    return out


def keyframe_bm_input(cfg, frame0, frame1, device, live=True):
    """The 748-slot sparse-BM input of a keyframe step on ``frame0``:
    ``(left, right, xy, valid)``. The slots are ``frame0``'s detections, then
    ``feature_capacity`` slots of ``frame1``'s detections (tiled) standing in
    for the tracked inliers. ``live``: the engine's usual load, the new
    detections deduplicated against the tracked ones and the valid slots cut
    to ``bm_compact_slots`` (the plain version compacts); else every slot
    valid (it matches at full width)."""
    import torch

    from stereo_vo_tpu_torch.frontend.detect import dedup_new_features, detect_features

    fc = cfg.frontend
    f_cap = cfg.backend.feature_capacity
    left = torch.from_numpy(frame0.left).to(device).to(torch.float32)
    right = torch.from_numpy(frame0.right).to(device).to(torch.float32)
    det_xy, det_valid = detect_features(left, fc)
    trk_xy, trk_valid = detect_features(
        torch.from_numpy(frame1.left).to(device).to(torch.float32), fc)
    pts = trk_xy[trk_valid]
    feat_xy = pts[torch.arange(f_cap, device=device) % pts.shape[0]]
    if live:
        feat_valid = torch.arange(f_cap, device=device) < pts.shape[0]
        new_valid = dedup_new_features(det_xy, det_valid, feat_xy, feat_valid, fc.min_distance)
        valid = torch.cat([new_valid, feat_valid])
        valid &= torch.cumsum(valid.to(torch.int64), 0) <= fc.bm_compact_slots
    else:
        valid = torch.ones(det_xy.shape[0] + f_cap, dtype=torch.bool, device=device)
    return left, right, torch.cat([det_xy, feat_xy]).contiguous(), valid
