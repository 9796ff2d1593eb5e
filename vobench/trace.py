"""The traced stretch of a ``--trace 1`` run: one more pass under
``torch.profiler`` after the measured window, read from the profiler's raw
events.

- ``busy_s``: the union of the intervals of the device's operations
  (kernels, copies, sets); ``window_s``: the stretch's wall time.
- ``device_ops``: device time by operation name, the ten largest.
- ``idle_gaps``: the device's idle time between its operations, by the
  harness span (``drive.SPANS``) the host was in at each gap's middle
  (``host`` where it was in none), the ten largest.
- ``launches``: each hand kernel's launches in the trace beside those the
  port counted on the device over the same stretch
  (``VOEngine.flush_launches`` into each wrapper's ``launches``);
  ``agree`` says whether every pair is equal. ``torch.profiler`` is known to
  lose kernels of conditional bodies (PERF.md); where the pairs differ,
  ``busy_s`` leaves out the lost kernels' time.
"""

from __future__ import annotations

import collections
from typing import Dict, List, Tuple

import torch

from vobench.drive import SPANS

# the port's hand kernels: wrapper name -> the kernel's name in a trace
KERNELS = {"lk_level_pass": "lk_level_kernel", "stereo_bm_at": "stereo_bm_at_kernel",
           "extract_regions": "extract_regions_kernel", "greedy_nms": "greedy_nms_kernel",
           "ba_build": "ba_build_kernel", "ba_damp_reduce": "ba_damp_reduce_kernel",
           "ba_step": "ba_step_kernel", "ba_cost": "ba_cost_kernel"}


def _on_device(e) -> bool:
    return str(e.device_type()).endswith("CUDA")


def _annotation(e) -> bool:
    """A ``record_function`` range (drawn on the host and, as a copy, on the
    device's timeline), not an operation."""
    return bool(e.is_user_annotation())


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[List[int]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def wrapper_launches() -> Dict[str, int]:
    """Each hand kernel wrapper's ``launches``, by wrapper name."""
    from stereo_vo_tpu_torch.engine.graphs import COUNTED

    return {w.__name__: int(w.launches) for w in COUNTED if w.__name__ in KERNELS}


def read(prof, t0_ns: int, t1_ns: int, counted: Dict[str, int]) -> dict:
    """The stretch ``[t0_ns, t1_ns]`` of ``prof`` (the profiler's clock)
    read as the module docstring says; ``counted`` the wrappers' launches
    over it."""
    device: List[Tuple[int, int, str]] = []
    host: List[Tuple[int, int, str]] = []
    for e in prof.profiler.kineto_results.events():
        a = e.start_ns()
        b = a + e.duration_ns()
        if _on_device(e):
            if not _annotation(e):
                device.append((a, b, e.name()))
        elif e.name() in SPANS:
            host.append((a, b, e.name()))
    busy = _union([(max(a, t0_ns), min(b, t1_ns)) for a, b, _ in device
                   if b > t0_ns and a < t1_ns])
    ops = collections.Counter()
    for a, b, name in device:
        ops[name] += (b - a) / 1e9
    gaps = collections.Counter()
    edges = [t0_ns] + [x for iv in busy for x in iv] + [t1_ns]
    host.sort()
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) // 2
        inside = [h for h in host if h[0] <= mid < h[1]]
        # the innermost span: the latest to start
        gaps[max(inside)[2] if inside else "host"] += (b - a) / 1e9
    traced = {w: sum(1 for _, _, name in device if k in name) for w, k in KERNELS.items()}
    launches = {w: [traced[w], counted.get(w, 0)] for w in KERNELS}
    return {
        "busy_s": sum(b - a for a, b in busy) / 1e9,
        "window_s": (t1_ns - t0_ns) / 1e9,
        "device_ops": [[n, s] for n, s in ops.most_common(10)],
        "idle_gaps": [[n, s] for n, s in gaps.most_common(10)],
        "launches": launches,
        "agree": all(t == c for t, c in launches.values()),
    }


def traced_pass(driver, engine) -> dict:
    """One pass of ``driver`` under the profiler, read."""
    from torch.profiler import ProfilerActivity, profile

    engine.flush_launches()
    before = wrapper_launches()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function("traced_pass"):
            driver.run(0.0, whole_passes=True)
        torch.cuda.synchronize()
    engine.flush_launches()
    after = wrapper_launches()
    counted = {w: after[w] - before[w] for w in after}
    marks = [e for e in prof.profiler.kineto_results.events()
             if e.name() == "traced_pass" and not _on_device(e)]
    t0 = marks[0].start_ns()
    return read(prof, t0, t0 + marks[0].duration_ns(), counted)
