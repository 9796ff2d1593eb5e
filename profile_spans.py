#!/usr/bin/env python3
"""The port's own spans over the benchmark's cells, on one GPU.

    python3 profile_spans.py [--cells kitti00.stream ...] [--seed N] [--seconds 10]
                             [--out spans_out]

For each cell of ``BENCHMARK.json`` named (all three by default) it renders
the seed's world as ``vobench/run.py`` does, builds two engines on the card,
one with ``trace=False`` and one with ``trace=True``, drives one warm pass
through each (the traced engine's records of it dropped) and then measured
windows of ``--seconds`` in turns off, on, on, off, off, on (``vobench/drive.py``'s
``Driver``, the end-to-end metrics of ``vobench/metrics.py``): the cost of
tracing when it is on. From each traced window's records (``VOEngine.
trace_records()``) it reads ``READINGS``, the per-layer numbers the spans
serve, and beside them the records dropped, the share of keyframe steps
whose ``track``, ``pnp``, ``kf_prep`` and ``ba`` spans lie inside their
``step`` span, the ``step`` span's self time, the earliest a device span
began before the host span that enqueued it, and the device's idle time by
program host span. Last, one pass of the traced engine under
``torch.profiler``: each top-level stamp kernel's start in the profile,
put onto ``perf_counter_ns()`` through one host marker both record, against
the program's own reading of it (the clock agreement). It also reads the
device clock's tick and the card's name and power limit. Each cell runs in
a process of its own: a profiler that has run slows a process's later
calls. One JSON line per cell on standard output, each cell's whole reading
in ``<out>/spans.<cell>.json`` and all of them in ``<out>/spans.json``.
Exits non-zero without a CUDA device or when a cell fails. Imports neither
JAX nor the JAX package.
"""

from __future__ import annotations

import os

if __name__ == "__main__":
    # one thread for torch's and numpy's pools, as vobench/run.py runs
    for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ.setdefault(_var, "1")

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import time  # noqa: E402
from typing import Dict, Optional  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
CELLS = ("kitti00.stream", "d435i.stream", "kitti00.replay")
TURNS = (False, True, True, False, False, True)
# the device spans a keyframe step's layers record, which lie inside its step
LAYERS = ("track", "pnp", "kf_prep", "ba")
MARKER = "profile_spans.clock_marker"
# host markers a profiled pass opens with: the one whose profiled begin or
# end the host's reads around it bracket most tightly places the profile's
# clock
MARKERS = 32


def _median_ms(spans) -> Optional[float]:
    return float(statistics.median(s.ms for s in spans)) if spans else None


def _keyframe_calls(trace) -> set:
    """The step calls that ran the keyframe-prep body: the keyframe steps."""
    return {s.call for s in trace.named("kf_prep")}


def _whole(fn):
    """A reading that gives None for no trace or one with dropped records."""
    def read(trace):
        if trace is None or trace.dropped:
            return None
        return fn(trace)
    read.__doc__ = fn.__doc__
    read.__name__ = fn.__name__
    return read


@_whole
def track_device_ms(trace):
    """Tracking: the median ``track`` span over the steps, ms."""
    return _median_ms(trace.named("track"))


@_whole
def step_enqueue_ms(trace):
    """Host path: the median ``step.enqueue`` host span over the cruise
    steps (no keyframe-prep body), ms."""
    kf = _keyframe_calls(trace)
    return _median_ms([s for s in trace.named("step.enqueue", "host") if s.call not in kf])


@_whole
def stream_idle_pct(trace):
    """Host path: 100 x the window's share outside the program's device
    spans (the first program host span to the last device span), %."""
    return trace.idle_pct if trace.named("step") else None


@_whole
def pnp_device_ms(trace):
    """PnP: the median ``pnp`` span over the steps that ran it, ms."""
    return _median_ms(trace.named("pnp"))


@_whole
def kf_prep_device_ms(trace):
    """Keyframe work: the median ``kf_prep`` span over the keyframe steps, ms."""
    return _median_ms(trace.named("kf_prep"))


@_whole
def ba_device_ms(trace):
    """Bundle adjustment: the median ``ba`` span over the keyframe steps, ms."""
    return _median_ms(trace.named("ba"))


@_whole
def replay_idle_pct(trace):
    """Driver and host path of a replay: as ``stream_idle_pct``, the chunks'
    ``preprocess`` spans among the device's, %."""
    return trace.idle_pct if trace.named("preprocess") else None


READINGS = {fn.__name__: fn for fn in (track_device_ms, step_enqueue_ms, stream_idle_pct,
                                        pnp_device_ms, kf_prep_device_ms, ba_device_ms,
                                        replay_idle_pct)}


def inside_share(trace) -> Optional[float]:
    """The share of keyframe steps whose ``LAYERS`` spans all lie inside
    their ``step`` span."""
    steps = {s.call: s for s in trace.named("step")}
    kf = sorted(_keyframe_calls(trace) & set(steps))
    if not kf:
        return None
    by_call: Dict[int, list] = {}
    for s in trace.spans:
        if s.clock == "device" and s.name in LAYERS:
            by_call.setdefault(s.call, []).append(s)
    ok = 0
    for call in kf:
        step, layers = steps[call], by_call.get(call, [])
        ok += ({s.name for s in layers} == set(LAYERS)
               and all(step.begin_ns <= s.begin_ns and s.end_ns <= step.end_ns for s in layers))
    return ok / len(kf)


def span_numbers(trace) -> dict:
    """What the module docstring lists beside ``READINGS``, from one
    window's trace."""
    kf = _keyframe_calls(trace)
    steps = trace.named("step")
    leads = [(s.begin_ns - trace.spans[s.parent].begin_ns) / 1e3 for s in trace.spans
             if s.clock == "device" and s.parent is not None
             and trace.spans[s.parent].clock == "host"]
    width = trace.window_ns[1] - trace.window_ns[0]
    return {
        "dropped": trace.dropped,
        "spans": len(trace.spans),
        "calibration_error_us": trace.calibration_error_ns / 1e3,
        "keyframe_steps": len(kf),
        "layers_inside_step_share": inside_share(trace),
        "step_self_ms": {
            "cruise": _median_self([s for s in steps if s.call not in kf]),
            "keyframe": _median_self([s for s in steps if s.call in kf])},
        "step_device_ms": {
            "cruise": _median_ms([s for s in steps if s.call not in kf]),
            "keyframe": _median_ms([s for s in steps if s.call in kf]),
            "keyframe_p95": _quantile([s.ms for s in steps if s.call in kf], 0.95)},
        "bootstrap_device_ms": _median_ms(trace.named("bootstrap")),
        "preprocess_device_ms": _median_ms(trace.named("preprocess")),
        "device_start_after_host_us_min": min(leads) if leads else None,
        "window_s": width / 1e9,
        "busy_s": trace.busy_ns / 1e9,
        "idle_s": {k: v / 1e9 for k, v in sorted(trace.idle_ns.items(), key=lambda kv: -kv[1])},
    }


def _median_self(spans) -> Optional[float]:
    return float(statistics.median(s.self_ns / 1e6 for s in spans)) if spans else None


def _quantile(values, q) -> Optional[float]:
    import numpy as np

    return float(np.quantile(values, q)) if values else None


def latency_split(win) -> dict:
    """A window's streamed steps: the keyframe share and the median of its
    keyframe and cruise steps' latency, ms (bootstraps left out)."""
    import numpy as np

    steps = [s for s in win.steps if s.kind == "step"]
    kf = [s.seconds * 1e3 for s in steps if s.summary[7]]
    cruise = [s.seconds * 1e3 for s in steps if not s.summary[7]]
    return {"keyframe_share": len(kf) / len(steps) if steps else None,
            "kf_step_ms": float(np.median(kf)) if kf else None,
            "cruise_step_ms": float(np.median(cruise)) if cruise else None}


def markers():
    """``MARKERS`` host markers: per marker ``perf_counter_ns()`` before
    entering ``MARKER``, just inside it, just before leaving it and after."""
    from torch.profiler import record_function

    out = []
    for _ in range(MARKERS):
        a = time.perf_counter_ns()
        with record_function(MARKER):
            a2 = time.perf_counter_ns()
            b1 = time.perf_counter_ns()
        out.append((a, a2, b1, time.perf_counter_ns()))
    return out


def profile_shift(prof, brackets):
    """``(shift, error)``, ns: the profile's host clock plus ``shift`` is
    ``perf_counter_ns()``, from the marker whose begin (between the reads
    before and inside it) or end (between the reads inside and after it) is
    bracketed most tightly; ``error`` half that bracket."""
    events = sorted((e for e in prof.profiler.kineto_results.events()
                     if e.name() == MARKER and "CUDA" not in str(e.device_type())),
                    key=lambda e: e.start_ns())
    best = None
    for e, (a, a2, b1, b) in zip(events, brackets):
        for lo, hi, t in ((a, a2, e.start_ns()), (b1, b, e.start_ns() + e.duration_ns())):
            if best is None or hi - lo < 2 * best[1]:
                best = ((lo + hi) / 2 - t, (hi - lo) / 2)
    return best


def clock_agreement(prof, trace, brackets) -> dict:
    """Each top-level stamp kernel's start in ``prof``, put onto the host
    clock by the markers (``profile_shift``), against the nearest of the
    program's readings of the top-level device spans' begins and ends, us
    (``signed``: the program's reading less the profile's)."""
    import bisect

    events = list(prof.profiler.kineto_results.events())
    shift, error = profile_shift(prof, brackets)
    kernels = sorted(e.start_ns() + shift for e in events
                     if "CUDA" in str(e.device_type()) and "stamp_kernel" in e.name())
    readings = [t for s in trace.spans if s.clock == "device"
                and (s.parent is None or trace.spans[s.parent].clock == "host")
                for t in (s.begin_ns, s.end_ns)]
    signed = []
    for t in readings:
        k = bisect.bisect_left(kernels, t)
        near = [kernels[j] for j in (k - 1, k) if 0 <= j < len(kernels)]
        if near:
            signed.append(min((t - x for x in near), key=abs) / 1e3)
    diffs = sorted(abs(d) for d in signed)
    return {"stamp_kernels_in_profile": len(kernels), "readings": len(readings),
            "median_abs_us": statistics.median(diffs) if diffs else None,
            "p90_abs_us": diffs[int(0.9 * (len(diffs) - 1))] if diffs else None,
            "max_abs_us": diffs[-1] if diffs else None,
            "median_signed_us": statistics.median(signed) if signed else None,
            "shift_ms": shift / 1e6, "marker_error_us": error / 1e3}


def card_info() -> dict:
    import torch

    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        smi = f"nvidia-smi: {e}"
    return {"name": torch.cuda.get_device_name(0), "nvidia_smi": smi}


def run_cell(name: str, seed: int, seconds: float, log) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from stereo_vo_tpu_torch.engine.step import VOEngine, parse_summary
    from vobench import manifest, metrics, world
    from vobench.drive import Driver
    from vobench.run import port_config

    cell = manifest.load_cell(name)
    n = int(cell.traffic["pass_frames"])
    lefts, rights = world.render_frames(cell.config, n, seed, min(8, os.cpu_count() or 1))
    dev = torch.device("cuda")
    cfg = port_config(cell.config)
    engines = {on: VOEngine(cfg, lefts.shape[1:], device=dev, trace=on) for on in (False, True)}
    drivers = {on: Driver(e, parse_summary, lefts, rights, cell.traffic)
               for on, e in engines.items()}
    for on in (False, True):
        drivers[on].run(0.0, whole_passes=True)
    engines[True].trace_records()
    torch.cuda.synchronize(dev)
    turns = []
    for on in TURNS:
        gc.collect()
        gc.freeze()
        try:
            win = drivers[on].run(seconds)
        finally:
            gc.unfreeze()
        row = {"trace": on, **metrics.end_to_end(win), **latency_split(win)}
        if on:
            t0 = time.perf_counter()
            trace = engines[True].trace_records()
            row["drain_s"] = time.perf_counter() - t0
            row["readings"] = {k: fn(trace) for k, fn in READINGS.items()}
            row["spans"] = span_numbers(trace)
        turns.append(row)
        log(f"{name} trace={on}: " + json.dumps({k: v for k, v in row.items()
                                                 if k not in ("spans",)}))
    engines[True].trace_records()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        brackets = markers()
        drivers[True].run(0.0, whole_passes=True)
        torch.cuda.synchronize(dev)
    profiled = engines[True].trace_records()
    out = {"cell": name, "seed": seed, "seconds": seconds, "turns": turns,
           "cost": _cost(turns, [m["name"] for m in cell.end_to_end]),
           "clock_agreement": clock_agreement(prof, profiled, brackets),
           "profiled_pass": span_numbers(profiled)}
    del drivers, engines
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _cost(turns, names) -> dict:
    """Each of the cell's end-to-end metrics ``names``: its median with
    tracing on over off."""
    out = {}
    for key in names:
        off = [t[key] for t in turns if not t["trace"] and key in t]
        on = [t[key] for t in turns if t["trace"] and key in t]
        if off and on:
            out[key] = {"off": statistics.median(off), "on": statistics.median(on),
                        "on_over_off": statistics.median(on) / statistics.median(off)}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cells", nargs="+", default=list(CELLS))
    ap.add_argument("--seed", type=int, default=3800000017)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--out", default=os.path.join(HERE, "spans_out"),
                    help="the directory the readings are written to")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("profile_spans.py: no CUDA device", file=sys.stderr)
        return 1
    torch.set_num_threads(1)
    from stereo_vo_tpu_torch.utils.profiling import Recorder, timer_tick

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    out_dir = args.out
    os.makedirs(out_dir, exist_ok=True)
    if len(args.cells) == 1:
        res = run_cell(args.cells[0], args.seed, args.seconds, log)
        with open(os.path.join(out_dir, f"spans.{args.cells[0]}.json"), "w") as f:
            json.dump(res, f, indent=1)
        print(json.dumps({key: res[key] for key in ("cell", "cost", "clock_agreement")}
                         | {"readings": [t.get("readings") for t in res["turns"]
                                         if t["trace"]]}), flush=True)
        return 0
    head = {"card": card_info(), "timer": timer_tick(torch.device("cuda")),
            "calibration_error_us": Recorder("cuda").calibration.error_ns / 1e3}
    print(json.dumps(head), flush=True)
    results = [head]
    for k, name in enumerate(args.cells):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--cells", name,
                               "--seed", str(args.seed + k), "--seconds", str(args.seconds),
                               "--out", out_dir],
                              stdout=subprocess.PIPE, text=True)
        sys.stdout.write(proc.stdout)
        if proc.returncode != 0:
            log(f"{name}: exit {proc.returncode}")
            return proc.returncode
        with open(os.path.join(out_dir, f"spans.{name}.json")) as f:
            results.append(json.load(f))
    with open(os.path.join(out_dir, "spans.json"), "w") as f:
        json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
