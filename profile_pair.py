#!/usr/bin/env python3
"""Paired profile of the port's streamed replay on one GPU: the
``stereo_vo_tpu_torch`` of this checkout against the one of another tree of
the repository (an earlier commit), in one call.

    git archive <commit> | tar -x -C <dir>    # a directory .gitignore lists
    python3 profile_pair.py <dir>

Host speed drifts within a call, so the trees run in turns old, new, new,
old, each in a child process that puts its tree first on ``sys.path``. A turn
renders the 129-frame synthetic world of ``chip_smoke.py`` phase 5 and, on
that tree's package, first the timed replays, before any profiler runs in
the process: the chunked replay (``run_vo(chunk_size=64,
preload_device=True)``) and the photo world's seed 11 chunked by 32; then
this checkout's ``utils/profiling.py``: ``profile_replay`` (frames 65-72
profiled, 49-80 timed: the calls, wall and device ms of each cruise and
keyframe step), ``profile_chunk`` (frames 65-128 as one profiled
``replay_chunk`` call: the syncs and launches inside it) and, on the
20-frame world of phase 4 (every frame a keyframe), ``profile_keyframes``
(steps 8-11 profiled), ``profile_solves`` (the bundle adjustments of
steps 8-11, each from its window replayed as a graph of its own: its LM
loop's stop, device ms and device kernels, and per LM body) and
``profile_step_parts`` (steps 8-11 run eagerly, their device ms and kernels
split into detection, BM, PnP and BA); and one ``stereo_bm_at`` call at the 748-slot
keyframe input of ``keyframe_bm_input`` (CUDA events, median of 20 samples
of 10 calls), all through that tree's public functions. It prints one JSON
line. Each tree builds its own kernels at first use. Exits non-zero without
a CUDA device or when a turn fails.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
TURNS = ("old", "new", "new", "old")


def _load_here(name: str, *parts: str):
    """A module of this checkout, loaded from its file."""
    spec = importlib.util.spec_from_file_location(name, os.path.join(HERE, *parts))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _turn(tree: str) -> None:
    sys.path.insert(0, tree)
    import torch

    import stereo_vo_tpu_torch
    from stereo_vo_tpu_torch.core.config import load_config
    from stereo_vo_tpu_torch.data.synthetic import SyntheticStereoSequence, load_sample_photo
    from stereo_vo_tpu_torch.engine.driver import run_vo
    from stereo_vo_tpu_torch.ops.stereo_bm import stereo_bm_at

    profiling = _load_here("_profiling_here", "stereo_vo_tpu_torch", "utils", "profiling.py")
    smoke = _load_here("_chip_smoke_here", "chip_smoke.py")

    cfg = load_config("kitti00")
    world = SyntheticStereoSequence(cam=cfg.camera, n_frames=129, shape=(376, 1241),
                                    n_points=4000, seed=0, speed=0.8, yaw_rate=0.003)
    frames = list(world)
    dev = torch.device("cuda:0")
    run = run_vo(iter(frames), cfg, chunk_size=64, preload_device=True, device=dev)
    photo = list(SyntheticStereoSequence(cam=cfg.camera, shape=(376, 1241), seed=11,
                                         texture=load_sample_photo(), **smoke.PHOTO_WORLD))
    photo_run = run_vo(iter(photo), cfg, chunk_size=smoke.PHOTO_CHUNK, preload_device=True,
                       device=dev)
    row = profiling.profile_replay(cfg, frames, dev)
    chunk = profiling.profile_chunk(cfg, frames, 64, dev)
    kf_frames = list(SyntheticStereoSequence(cam=cfg.camera, n_frames=20, shape=(376, 1241),
                                             n_points=4000, seed=0, speed=0.8,
                                             yaw_rate=0.003))
    keyframe = profiling.profile_keyframes(cfg, kf_frames, dev)
    solves = profiling.profile_solves(cfg, kf_frames, dev)
    parts = profiling.profile_step_parts(cfg, kf_frames, dev)
    left, right, xy, valid = profiling.keyframe_bm_input(cfg, kf_frames[0], kf_frames[1], dev)
    fc = cfg.frontend
    bm_ms = smoke._time_ms(torch, lambda: stereo_bm_at(
        left, right, xy, valid, num_disparities=fc.bm_num_disparities,
        block_size=fc.bm_block_size, prefilter_cap=fc.bm_prefilter_cap,
        texture_threshold=fc.bm_texture_threshold, uniqueness_ratio=fc.bm_uniqueness_ratio,
        compact_slots=fc.bm_compact_slots))
    print(json.dumps({"package": os.path.dirname(stereo_vo_tpu_torch.__file__),
                      "chunked_frames_per_s": run.frames_per_sec,
                      "photo_s11_chunked_frames_per_s": photo_run.frames_per_sec, **row,
                      "chunk": chunk, "keyframe": keyframe, "solves": solves, "parts": parts,
                      "stereo_bm_at_748_ms": bm_ms, "stereo_bm_at_748_valid": int(valid.sum())}),
          flush=True)


def main(argv) -> int:
    if len(argv) == 2 and argv[0] == "--turn":
        _turn(os.path.abspath(argv[1]))
        return 0
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("profile_pair: no CUDA device is available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    trees = {"old": os.path.abspath(argv[0]), "new": HERE}
    for turn, label in enumerate(TURNS):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--turn",
                               trees[label]], capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(f"profile_pair: turn {turn} ({label}) failed:\n{proc.stderr[-4000:]}",
                  file=sys.stderr)
            return 1
        row = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps({"turn": turn, "tree": label, **row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
