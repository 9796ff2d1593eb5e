"""Profiling utilities (counterpart of ``stereo_vo_tpu/utils/profiling.py``).

Host-side stage timers for the driver loop, and a context manager around
``torch.profiler`` for device traces. ``summarize_trace`` sums the profile by
kernel name: on a CUDA device, the self device time of each kernel; on the
CPU, where there are no kernels, the self CPU time of each operator.

    with device_trace("out/trace") as prof:
        engine.step(state, left, right)
    for ms, name in summarize_trace(prof):
        print(ms, name)

``profile_replay`` profiles a window of streamed steps on the card: kernel
launches, CUDA graph launches, synchronizations and device time per frame,
the device launches of the port's hand-written kernels, the runtime calls
inside each keyframe branch, step and ``track_step`` latency.
``profile_keyframes`` does the same for keyframe steps (the 20-frame world,
where every frame is a keyframe), with the wrappers' own launch counts
beside the trace's, and ``keyframe_bm_input`` builds the 748-slot sparse-BM
input of a keyframe step.
"""

from __future__ import annotations

import collections
import contextlib
import os
import statistics
import time
from typing import Dict, List, Optional, Tuple


class StageTimer:
    """Accumulating wall-clock timer for named host-side stages."""

    def __init__(self):
        self.totals: Dict[str, float] = collections.defaultdict(float)
        self.counts: Dict[str, int] = collections.defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> Dict[str, dict]:
        return {
            k: {
                "total_s": round(v, 4),
                "count": self.counts[k],
                "mean_ms": round(1000 * v / max(self.counts[k], 1), 3),
            }
            for k, v in sorted(self.totals.items(), key=lambda kv: -kv[1])
        }


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
               and not getattr(e, "is_user_annotation", False) and e.key != BRANCH_RANGE]
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


def range_calls(prof, name: str) -> List[Dict[str, int]]:
    """For each ``record_function(name)`` range in a profile, in order, the
    runtime calls inside it: ``syncs``, ``launches`` and ``graph_launches``,
    as ``runtime_calls`` counts them. Only host-side events count: the
    profiler also draws each range on the device's timeline."""
    from torch.autograd import DeviceType

    events = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    ranges = sorted((e.time_range.start, e.time_range.end) for e in events if e.name == name)
    out = []
    for start, end in ranges:
        calls = {"syncs": 0, "launches": 0, "graph_launches": 0}
        for e in events:
            if not (start <= e.time_range.start and e.time_range.end <= end):
                continue
            if "Synchronize" in e.name:
                calls["syncs"] += 1
            elif e.name in _KERNEL_LAUNCH_CALLS:
                calls["launches"] += 1
            elif e.name in _GRAPH_LAUNCH_CALLS:
                calls["graph_launches"] += 1
        out.append(calls)
    return out


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
                "greedy_nms_kernel")
PORT_WRAPPERS = {"lk_level_kernel": ("ops.lk", "lk_level_pass"),
                 "stereo_bm_at_kernel": ("ops.stereo_bm", "stereo_bm_at"),
                 "extract_regions_kernel": ("ops.regions", "extract_regions"),
                 "greedy_nms_kernel": ("ops.shi_tomasi", "greedy_nms")}
# the profiler range around the keyframe branch (engine/step.py BRANCH_RANGE)
BRANCH_RANGE = "VOEngine.keyframe_branch"


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


def _trace_counts(prof, n, counted=None) -> dict:
    """Launches, CUDA graph launches, syncs and device ms per step over ``n``
    profiled steps, the device launches of each of ``PORT_KERNELS`` in the
    trace and, given ``counted`` (the wrappers' launch counts over the same
    steps), those beside them; and the runtime calls inside each keyframe
    branch (``BRANCH_RANGE``)."""
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
        "keyframe_branches": range_calls(prof, BRANCH_RANGE),
    }
    if counted is not None:
        out["wrapper_launches"] = counted
    return out


def profile_replay(cfg, frames, device) -> dict:
    """Stream ``frames`` (``StereoFrame``s, at least ``CRUISE_FRAMES[1]``)
    through a fresh ``VOEngine`` on ``device`` (a CUDA device) and profile
    the steps of ``PROFILED_FRAMES`` with ``torch.profiler``.

    Returns per-frame ``launches``, ``graph_launches``, ``syncs`` and
    ``device_ms`` over the profiled frames, the device launches there of each
    of ``PORT_KERNELS`` (read from the trace, not from the wrappers'
    counters), the runtime calls inside each keyframe branch, and, over the
    unprofiled steps of ``CRUISE_FRAMES``, the step wall p50 and the p50 of
    one extra synchronized ``track_step`` per frame (its result discarded),
    both in ms."""
    import torch

    from stereo_vo_tpu_torch.engine.step import VOEngine, parse_summary
    from stereo_vo_tpu_torch.frontend.track import track_step
    from stereo_vo_tpu_torch.ops.pyramid import build_pyramid

    engine = VOEngine(cfg, frames[0].left.shape, device=device)
    state, _ = engine.bootstrap(engine.init_state(), frames[0].left, frames[0].right)
    step_ms, track_ms, hinted = [], [], []

    def advance(state, f, timed):
        if timed:
            pyr = build_pyramid(engine._image(f.left), cfg.frontend.lk_max_level)
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            track_step(state.tracker, tuple(pyr), cfg.frontend)
            torch.cuda.synchronize(device)
            track_ms.append(1e3 * (time.perf_counter() - t0))
        t0 = time.perf_counter()
        state, out = engine.step(state, f.left, f.right)
        row = parse_summary(out.summary)[1]
        torch.cuda.synchronize(device)
        if timed:
            step_ms.append(1e3 * (time.perf_counter() - t0))
            hinted.append(row["hinted"])
        return state

    first, end = PROFILED_FRAMES
    for i in range(1, first):
        state = advance(state, frames[i], i >= CRUISE_FRAMES[0])
    with device_trace() as prof:
        for i in range(first, end):
            state = advance(state, frames[i], False)
    for i in range(end, CRUISE_FRAMES[1]):
        state = advance(state, frames[i], True)
    return {
        "frames": [first, end],
        **_trace_counts(prof, end - first),
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
    counts (``wrapper_launches``), the runtime calls inside each keyframe
    branch, and how many of the profiled steps were keyframes."""
    import torch

    from stereo_vo_tpu_torch.engine.step import VOEngine, parse_summary

    engine = VOEngine(cfg, frames[0].left.shape, device=device)
    state, _ = engine.bootstrap(engine.init_state(), frames[0].left, frames[0].right)
    torch.cuda.synchronize(device)
    first, end = KEYFRAME_PROFILED
    step_ms, keyframes = [], 0

    def advance(state, f, timed):
        t0 = time.perf_counter()
        state, out = engine.step(state, f.left, f.right)
        row = parse_summary(out.summary)[1]
        torch.cuda.synchronize(device)
        if timed:
            step_ms.append(1e3 * (time.perf_counter() - t0))
        return state, row["is_keyframe"]

    for i in range(1, first):
        state, _ = advance(state, frames[i], i >= KEYFRAME_TIMED_FROM)
    before = wrapper_launches()
    with device_trace() as prof:
        for i in range(first, end):
            state, kf = advance(state, frames[i], False)
            keyframes += int(kf)
    after = wrapper_launches()
    for i in range(end, len(frames)):
        state, _ = advance(state, frames[i], True)
    counted = {k: after[k] - before[k] for k in PORT_KERNELS}
    return {
        "frames": [first, end],
        "step_ms_p50": statistics.median(step_ms),
        "keyframes_profiled": keyframes,
        **_trace_counts(prof, end - first, counted),
    }


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
