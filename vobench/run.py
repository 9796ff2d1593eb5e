"""Run one benchmark cell once and print its result as one JSON line.

    python3 -m vobench.run --workload kitti00.replay --seed 7 --seconds 10 --trace 0

From the root of a checkout that holds ``BENCHMARK.json``, this folder and
the port (``stereo_vo_tpu_torch``). Set-up renders the seed's world (in
this process: a pool's burst on every core slowed the window after it,
PERF.md §6), builds one engine on the card and drives one warm pass, which
captures every program the cell's traffic uses and keeps the program's
states at the checked frames. The window then runs passes for
``--seconds``; each pass drives the sequence from ``init_state()``
(``drive.py``). With ``--trace 0`` the result carries the cell's end-to-end
metrics; with ``--trace 1`` its per-layer metrics, read from the window's
spans, events and counts by ``layer_metrics/<name>.py``, and one more pass
under ``torch.profiler`` (``trace.py``). Once the window has closed and the
program's state is freed, the plain reference steps the checked frames on
the CPU and ``check.py`` decides ``correct``; the numbers compared are
printed beside their limits, last on standard error and last in the
result's line.

Exits non-zero, with no result, without as many CUDA devices as the cell
asks for, and if ``jax``, ``jaxlib``, ``flax`` or the JAX package
``stereo_vo_tpu`` is loaded once the window has closed.
"""

from __future__ import annotations

import os
import time

T_START = time.perf_counter()
if __name__ == "__main__":
    # one thread for every pool this process and its children keep (torch's,
    # numpy's): the port's host path is one thread, and the render and
    # reference pools put one process on each core
    for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ.setdefault(_var, "1")

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import multiprocessing  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402

from vobench import check, manifest, world  # noqa: E402

CACHE_DIR = os.path.join(manifest.HERE, ".cache")
FORBIDDEN = ("jax", "jaxlib", "flax", "stereo_vo_tpu")
REFERENCE_THREADS = 1
WORKERS = 8    # the render and reference pools' processes on the card's machine


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is one of
    ``FORBIDDEN`` (``stereo_vo_tpu_torch`` is not ``stereo_vo_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def port_config(config: dict):
    """The port's ``PipelineConfig`` of a configuration file."""
    from stereo_vo_tpu_torch.core.camera import CameraInfo
    from stereo_vo_tpu_torch.core.config import BackendConfig, FrontendConfig, PipelineConfig

    cam = config["camera"]
    return PipelineConfig(
        camera=CameraInfo(cam["focal"], cam["cx"], cam["cy"], cam["baseline"]),
        frontend=FrontendConfig(**config["pipeline"]["frontend"]),
        backend=BackendConfig(**config["pipeline"]["backend"]),
        frame_rate=cam["rate_hz"], name=config["name"],
    )


def _reference_engine(config: dict, shape):
    from vobench.reference.core.camera import CameraInfo
    from vobench.reference.core.config import BackendConfig, FrontendConfig, PipelineConfig
    from vobench.reference.engine.step import VOEngine

    cam = config["camera"]
    cfg = PipelineConfig(
        camera=CameraInfo(cam["focal"], cam["cx"], cam["cy"], cam["baseline"]),
        frontend=FrontendConfig(**config["pipeline"]["frontend"]),
        backend=BackendConfig(**config["pipeline"]["backend"]),
    )
    return VOEngine(cfg, shape, device="cpu")


@contextlib.contextmanager
def _reference_threads():
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(REFERENCE_THREADS)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def reference_pass(config: dict, traffic: dict, lefts, rights, tf32: bool = False,
                   keep=()):
    """The plain reference's one free pass over the frames, in the traffic's
    mode, on the CPU: ``(drive.Pass, drive.StateTap)`` with the states of
    the frames in ``keep``; ``tf32`` computes it as the control."""
    from vobench.drive import Driver, StateTap
    from vobench.reference.engine.step import parse_summary
    from vobench.reference.tf32 import tf32_products

    with _reference_threads():
        engine = _reference_engine(config, lefts.shape[1:])
        driver = Driver(engine, parse_summary, lefts, rights, traffic)
        with StateTap(engine, keep) as tap, \
                (tf32_products() if tf32 else contextlib.nullcontext()):
            return driver.run(0.0, whole_passes=True).passes[0], tap


def to_reference(tree):
    """A host copy of a port ``VOState`` as the reference's own ``VOState``
    (the same fields; the tensors cloned)."""
    import torch

    from vobench.reference.backend.window import WindowState
    from vobench.reference.engine.step import VOState
    from vobench.reference.frontend.track import TrackerState

    kinds = {"VOState": VOState, "TrackerState": TrackerState, "WindowState": WindowState}
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, tuple):
        items = [to_reference(x) for x in tree]
        return kinds[type(tree).__name__](*items) if hasattr(tree, "_fields") else tuple(items)
    return tree


def stepwise_sample(config: dict, n_frames: int, seed: int) -> list:
    """The frames the check steps from the program's state: frame 0 (the
    bootstrap from ``init_state()``) and a sample of the others drawn from
    the seed."""
    k = min(int(config["check"]["frames"]), n_frames - 1)
    rng = np.random.default_rng([seed, 0x5EB])
    return [0] + sorted(int(i) for i in rng.choice(np.arange(1, n_frames), k, replace=False))


def np_tree(tree):
    """A tree of host tensors with every tensor as a numpy array (so a pool
    pickles it as bytes)."""
    import torch

    if isinstance(tree, torch.Tensor):
        return tree.numpy()
    if isinstance(tree, tuple):
        items = [np_tree(x) for x in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return tree


def torch_tree(tree):
    """``np_tree`` undone."""
    import torch

    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree)
    if isinstance(tree, tuple):
        items = [torch_tree(x) for x in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return tree


_POOL_ENGINES: dict = {}


def _pool_init() -> None:
    import torch

    torch.set_num_threads(REFERENCE_THREADS)


def _reference_step(job):
    """A pool's task: one reference ``bootstrap`` (from ``init_state()``
    where ``state`` is None) or ``step`` from a state, ``(summary, state)``
    back as numpy."""
    config, kind, state, left, right = job
    key = (json.dumps([config["camera"], config["pipeline"]], sort_keys=True), left.shape)
    if key not in _POOL_ENGINES:
        _POOL_ENGINES[key] = _reference_engine(config, left.shape)
    engine = _POOL_ENGINES[key]
    state = engine.init_state() if state is None else torch_tree(state)
    fn = engine.bootstrap if kind == "bootstrap" else engine.step
    state, out = fn(state, left, right)
    return out.summary.numpy(), np_tree(state)


def reference_pool(workers: int):
    """A pool of ``workers`` fresh processes (spawned: they import neither
    the program nor the parent's CUDA state) for ``_reference_step``."""
    return multiprocessing.get_context("spawn").Pool(workers, initializer=_pool_init)


def close_pool(pool) -> None:
    pool.close()
    pool.terminate()
    pool.join()


def stepwise_jobs(config: dict, lefts, rights, tap, sample, n_done: int):
    """The reference's steps of the sampled frames: ``(k, job)`` for each
    sampled frame the program's pass made a call for (``job`` None where it
    finished the frame without one)."""
    out = []
    for k in sample:
        if k >= n_done:
            continue
        if k not in tap.after:
            out.append((k, None))
            continue
        state = None if k == 0 else np_tree(to_reference(tap.before[k]))
        out.append((k, (config, tap.kinds[k], state, lefts[k], rights[k])))
    return out


def stepwise_pairs(config: dict, lefts, rights, summaries, tap, sample, pool=None) -> list:
    """For each sampled frame of the program's pass (its ``summaries``, the
    states ``tap`` took), the reference's step (or bootstrap, as the
    program's call was) from the program's state before it: ``(program
    summary, reference summary, program state, reference state)``. The
    steps run in ``pool`` where one is given, else here."""
    jobs = stepwise_jobs(config, lefts, rights, tap, sample, len(summaries))
    run_jobs = [j for _, j in jobs if j is not None]
    if pool is not None:
        results = pool.map(_reference_step, run_jobs, chunksize=1)
    else:
        with _reference_threads():
            results = [_reference_step(j) for j in run_jobs]
    results = iter(results)
    pairs = []
    for k, job in jobs:
        if job is None:
            pairs.append((summaries[k], None, None, None))
        else:
            summ, state = next(results)
            pairs.append((summaries[k], summ, tap.after[k], torch_tree(state)))
    return pairs


def _summary_shares(win) -> dict:
    """Per pass: keyframe share, hint share, bootstrap ms."""
    out = []
    for p in win.passes:
        s = np.asarray(p.summaries)
        if len(s):
            out.append({"frames": len(s), "keyframe_share": float(s[:, 7].mean()),
                        "hint_share": float(s[:, 18].mean()), "bootstrap_ms": p.bootstrap_ms})
    return out


def _stream_split(win) -> str:
    """The streamed calls' medians: the whole latency, the part until the
    entry returned, and the fetch after it, ms."""
    if not win.steps:
        return ""
    lat = np.array([[s.seconds, s.call_seconds] for s in win.steps]) * 1000
    whole, call = np.median(lat[:, 0]), np.median(lat[:, 1])
    fetch = np.median(lat[:, 0] - lat[:, 1])
    return f"streamed calls: p50 {whole:.4f} ms, entry {call:.4f} ms, fetch {fetch:.4f} ms"


def run_cell(cell: manifest.Cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
             engine_hook=None, log=print, cache_dir=None, workers: int = 1):
    """Set up, warm, measure, check. Returns the result line's object (the
    ``check`` key last). ``engine_hook(engine)``, when given, may replace
    the engine's entries (the fault tests use it). With ``cache_dir`` the
    frames are read from (or rendered into) the render cache there;
    ``workers`` > 1 renders and steps the reference in pools of as many
    processes, started and ended outside the window."""
    import torch

    from stereo_vo_tpu_torch.engine.step import VOEngine, parse_summary
    from vobench import metrics, trace as trace_mod
    from vobench.drive import Driver, StateTap

    n_frames = int(cell.traffic["pass_frames"])
    if cache_dir is not None:
        lefts, rights = world.cached_frames(cell.config, n_frames, seed, cache_dir, workers)
    else:
        lefts, rights = world.render_frames(cell.config, n_frames, seed, workers)
    dev = torch.device(device)
    engine = VOEngine(port_config(cell.config), lefts.shape[1:], device=dev)
    if engine_hook is not None:
        engine_hook(engine)
    driver = Driver(engine, parse_summary, lefts, rights, cell.traffic)
    # the warm pass: every capture, and the program's states at the checked
    # frames (the window repeats it bitwise, which the check holds: the
    # outputs compared are the window's)
    sample = stepwise_sample(cell.config, n_frames, seed)
    with StateTap(engine, sample) as tap:
        warm = driver.run(0.0, whole_passes=True).passes[0]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - T_START
    log(f"setup: {setup_s:.3f} s, {n_frames} frames of {lefts.shape[1]}x{lefts.shape[2]}, "
        f"programs {len(getattr(engine, 'programs', {}))}")

    # what set-up left on the heap stays out of the window's collections
    gc.collect()
    gc.freeze()
    try:
        win = driver.run(seconds)
    finally:
        gc.unfreeze()
    shares = _summary_shares(win)
    log(f"window: {win.seconds:.4f} s, {win.frames} frames, {len(win.passes)} passes, "
        f"{len(win.steps)} streamed calls, {len(win.chunks)} chunks")
    log("passes: " + json.dumps(shares[:3] + (shares[-1:] if len(shares) > 3 else [])))
    if win.steps:
        log(_stream_split(win))
    if win.chunks and win.chunks[0].pending_at_return is not None:
        pending = sum(c.pending_at_return for c in win.chunks)
        log(f"chunk events: closing event pending at return in {pending} of "
            f"{len(win.chunks)} chunks")

    on_card = dev.type == "cuda"
    dev_info = {"platform": "gpu" if on_card else "cpu",
                "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
                "count": cell.chips,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev)) if on_card else 0}
    if trace and on_card:
        win.profile = trace_mod.traced_pass(driver, engine)
        dev_info["busy_s"] = win.profile["busy_s"]
        dev_info["window_s"] = win.profile["window_s"]
        log("launches traced / counted on the device: " + json.dumps(win.profile["launches"])
            + f" agree={win.profile['agree']}")

    if trace:
        values = {}
        for m in cell.per_layer:
            v = cell.readers[m["name"]](win)
            if v is not None:
                values[m["name"]] = (v, m["unit"])
    else:
        e2e = metrics.end_to_end(win)
        e2e["setup_s"] = setup_s
        values = {m["name"]: (e2e[m["name"]], m["unit"]) for m in cell.end_to_end
                  if m["name"] in e2e}

    passes = [p.summaries for p in win.passes]
    warm_gap = check.pass_spread([warm.summaries] + passes)
    log(f"window passes against the warm pass: largest difference {warm_gap}")
    attempted = win.frames
    failed = int(sum(int(not np.all(np.isfinite(s[:7]))) for p in passes for s in p))
    profile = win.profile
    del driver, engine, win
    gc.collect()
    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    travel = cell.config["world"]["speed"] * cell.config["world"]["scale"]
    pool = reference_pool(workers) if workers > 1 else None
    try:
        pairs = stepwise_pairs(cell.config, lefts, rights, warm.summaries, tap, sample, pool)
    finally:
        if pool is not None:
            close_pool(pool)
    numbers = check.step_gaps(pairs, travel)
    numbers["traj_err"] = check.traj_err(warm.summaries,
                                         world.gt_poses(cell.config, n_frames, seed), travel)
    numbers["warm_gap"] = warm_gap
    log(f"reference: {len(pairs)} frames stepped from the program's state, "
        f"{time.perf_counter() - t_ref:.1f} s on the CPU")
    limits = cell.config["limits"]
    result = {
        "correct": check.judge(numbers, limits),
        "attempted": attempted,
        "failed": failed,
        "metrics": {k: {"value": v, "unit": u} for k, (v, u) in values.items()},
        "device": dev_info,
    }
    if profile is not None:
        result["breakdown"] = {"device_ops": profile["device_ops"],
                               "idle_gaps": profile["idle_gaps"]}
    for k in numbers:
        if k not in limits:
            log(f"not compared: {k} = {numbers[k]!r}")
    result["check"] = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = manifest.load_cell(args.workload)

    # every build and kernel cache inside the checkout, at a fixed path
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(CACHE_DIR, "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(CACHE_DIR, "torch_extensions"))
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"vobench: {cell.name} needs {cell.chips} CUDA device(s), found {n}",
              file=sys.stderr)
        return 2

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), log=log,
                      cache_dir=os.path.join(CACHE_DIR, "frames"),
                      workers=min(WORKERS, os.cpu_count() or 1))
    found = forbidden_modules()
    if found:
        print(f"vobench: modules loaded that the port must not load: {found}", file=sys.stderr)
        return 3
    for k, c in result["check"].items():
        log(f"check {k} = {c['value']!r} (limit {c['limit']!r})")
    log(f"correct = {result['correct']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
