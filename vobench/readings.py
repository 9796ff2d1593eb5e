"""The readings that the limits of ``correct`` are set from: for one
configuration, the program's runs on the card and the control's
(``control.py``) on the CPU, each over the frames of a sample drawn from
the seed, one JSON line per seed with a row per checked frame
(``check.frame_row``), the numbers ``check.step_numbers`` makes of them and
the pass's ``traj_err``. For each of the program's seeds it also drives the
``replay`` mix and prints the largest difference of its summaries from the
``stream`` mix's (the check steps both through the same entries).

    python3 -m vobench.readings --config kitti00 --seeds 11 12 --control-seeds 21 22 \\
        --frames 48 --out chiprun_out/readings_kitti00.jsonl

The control and the reference's steps run in a pool of spawned processes,
one per core but one; the card's work runs here. Stops taking new seeds
after ``--deadline`` seconds.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import sys
import time

import numpy as np

from vobench import check, manifest, run, world


def _control_task(config, traffic, n, seed, sample, cache_dir):
    import torch

    from vobench import control

    torch.set_num_threads(run.REFERENCE_THREADS)
    lefts, rights = world.cached_frames(config, n, seed, cache_dir)
    rows, traj = control.control_rows(config, traffic, lefts, rights,
                                      world.gt_poses(config, n, seed), sample)
    return rows, traj


def _render_task(config, n, seed, cache_dir):
    world.cached_frames(config, n, seed, cache_dir)
    return seed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True, help="a configuration's name, or its file")
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--frames", type=int, default=48)
    ap.add_argument("--out", required=True)
    ap.add_argument("--deadline", type=float, default=1e9)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--pass-frames", type=int, default=0, help="frames a pass (0: the mix's)")
    ap.add_argument("--chunk-frames", type=int, default=0, help="replay's chunk (0: the mix's)")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()

    import torch

    from stereo_vo_tpu_torch.engine.step import VOEngine, parse_summary
    from vobench.drive import Driver, StateTap

    torch.set_num_threads(1)
    config = manifest.load_json(args.config if args.config.endswith(".json") else
                                os.path.join(manifest.HERE, "configs", args.config + ".json"))
    stream = manifest.load_json(os.path.join(manifest.HERE, "traffic", "stream.json"))
    replay = manifest.load_json(os.path.join(manifest.HERE, "traffic", "replay.json"))
    if args.pass_frames:
        stream["pass_frames"] = replay["pass_frames"] = args.pass_frames
    if args.chunk_frames:
        replay["chunk_frames"] = args.chunk_frames
    n = int(stream["pass_frames"])
    travel = config["world"]["speed"] * config["world"]["scale"]
    sampling = dict(config, check=dict(config["check"], frames=args.frames))
    cache_dir = os.path.join(run.CACHE_DIR, "frames")
    out = open(args.out, "a")

    def emit(obj):
        out.write(json.dumps(obj) + "\n")
        out.flush()
        print(json.dumps({k: v for k, v in obj.items() if k != "rows"}), flush=True)

    pool = run.reference_pool(max(1, (os.cpu_count() or 2) - 1))
    try:
        controls = {s: pool.apply_async(_control_task, (
            config, stream, n, s, run.stepwise_sample(sampling, n, s), cache_dir))
            for s in args.control_seeds}
        renders = {s: pool.apply_async(_render_task, (config, n, s, cache_dir))
                   for s in args.seeds}
        engine = None
        pending = []
        for s in args.seeds:
            if time.perf_counter() - t0 > args.deadline:
                break
            renders[s].get()
            lefts, rights = world.cached_frames(config, n, s, cache_dir)
            if engine is None:
                engine = VOEngine(run.port_config(config), lefts.shape[1:],
                                  device=torch.device(args.device))
            sample = run.stepwise_sample(sampling, n, s)
            with StateTap(engine, sample) as tap:
                prog = Driver(engine, parse_summary, lefts, rights, stream).run(
                    0.0, whole_passes=True).passes[0]
            rep = Driver(engine, parse_summary, lefts, rights, replay).run(
                0.0, whole_passes=True).passes[0]
            summaries = np.asarray(prog.summaries)
            gap = check.pass_spread([prog.summaries, rep.summaries])
            jobs = run.stepwise_jobs(config, lefts, rights, tap, sample, len(summaries))
            res = pool.map_async(run._reference_step, [j for _, j in jobs if j is not None],
                                 chunksize=1)
            pending.append((s, summaries, tap, jobs, gap, res))
        for s, summaries, tap, jobs, gap, res in pending:
            try:
                results = iter(res.get(timeout=max(1.0, args.deadline
                                                   - (time.perf_counter() - t0))))
            except multiprocessing.TimeoutError:
                emit({"config": config["name"], "side": "program", "seed": s,
                      "error": "deadline"})
                continue
            pairs = []
            for k, job in jobs:
                if job is None:
                    pairs.append((summaries[k], None, None, None))
                else:
                    summ, state = next(results)
                    pairs.append((summaries[k], summ, tap.after[k], run.torch_tree(state)))
            rows = check.frame_rows(pairs, travel)
            for (k, _), r in zip(jobs, rows):
                if r is not None:
                    r["k"] = k
            emit({"config": config["name"], "side": "program", "seed": s,
                  "numbers": check.step_numbers(rows),
                  "traj_err": check.traj_err(summaries, world.gt_poses(config, n, s), travel),
                  "replay_vs_stream": gap, "keyframe_share": float(summaries[:, 7].mean()),
                  "rows": rows, "seconds": time.perf_counter() - t0})
        for s, res in controls.items():
            left = args.deadline - (time.perf_counter() - t0)
            if left <= 0:
                break
            try:
                rows, traj = res.get(timeout=left)
            except Exception as e:    # noqa: BLE001 - a control that fails is a reading too
                emit({"config": config["name"], "side": "control", "seed": s, "error": repr(e)})
                continue
            emit({"config": config["name"], "side": "control", "seed": s,
                  "numbers": check.step_numbers(rows), "traj_err": traj, "rows": rows,
                  "seconds": time.perf_counter() - t0})
    finally:
        run.close_pool(pool)
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
