"""Profiling utilities (counterpart of ``stereo_vo_tpu/utils/profiling.py``).

Host-side stage timers for the driver loop, and a context manager around
``torch.profiler`` for device traces. ``summarize_trace`` sums the profile by
kernel name: on a CUDA device, the self device time of each kernel; on the
CPU, where there are no kernels, the self CPU time of each operator.

    with device_trace("out/trace") as prof:
        engine.step(state, left, right)
    for ms, name in summarize_trace(prof):
        print(ms, name)
"""

from __future__ import annotations

import collections
import contextlib
import os
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
    CPU time."""
    from torch.autograd import DeviceType

    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    if kernels:
        times = ((e.key, e.self_device_time_total) for e in kernels)
    else:
        times = ((e.key, e.self_cpu_time_total) for e in events)
    by_name = collections.Counter()
    for name, us in times:
        by_name[name] += us
    return [(round(us / 1000, 3), name) for name, us in by_name.most_common(top) if us > 0]
