#!/usr/bin/env python
"""Which stages of the port's CPU step change their float32 result with
torch's thread count.

    python tests/fixtures/thread_stages.py [--threads N]

Streams the 20-frame 376x1241 world of ``kitti00_w20.npz`` through the
port's ``run_vo`` on the CPU at one thread, recording the first call of
each stage (and of the bundle adjustment's parts); reruns each recorded
call at one thread and at ``N`` (torch's default count unless given) and
prints whether the two agree bitwise; then streams the world at ``N``
threads and prints its largest pose difference from the stored JAX run and
the frames whose integer fields differ. About a minute; imports no JAX.
"""

import argparse
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
REF = os.path.join(os.path.dirname(os.path.abspath(__file__)), "jax_reference", "kitti00_w20.npz")


def _leaves(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _leaves(v)]
    return []


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--threads", type=int, default=torch.get_num_threads())
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from stereo_vo_tpu_torch.backend import schur
    from stereo_vo_tpu_torch.core.config import load_config
    from stereo_vo_tpu_torch.data.synthetic import SyntheticStereoSequence
    from stereo_vo_tpu_torch.engine import step as step_module
    from stereo_vo_tpu_torch.engine.driver import run_vo
    from stereo_vo_tpu_torch.eval.parity import INT_KEYS, run_summaries

    ref = np.load(REF)
    cfg = load_config(str(ref["config"]))
    world = SyntheticStereoSequence(
        cam=cfg.camera, n_frames=int(ref["n_frames"]), shape=tuple(int(v) for v in ref["shape"]),
        n_points=int(ref["n_points"]), seed=int(ref["seed"]), speed=float(ref["speed"]),
        yaw_rate=float(ref["yaw_rate"]))
    frames = list(world)
    stages = [(step_module, n) for n in (
        "build_pyramid", "count_quality_peaks", "track_step", "pnp_ransac", "detect_features",
        "dedup_new_features", "triangulate_from_disparities", "add_keyframe")]
    stages += [(schur, n) for n in ("_lm_major_cost", "_build_system", "_damp_reduce",
                                    "_solve_from_system")]
    plain, calls = {}, {}
    for module, name in stages:
        fn = plain[name] = getattr(module, name)

        def recording(*a, _fn=fn, _name=name, **k):
            out = _fn(*a, **k)
            calls.setdefault(_name, (a, k))
            return out

        setattr(module, name, recording)
    torch.set_num_threads(1)
    try:
        run_vo(iter(frames), cfg, device="cpu")
    finally:
        for module, name in stages:
            setattr(module, name, plain[name])
    for name, (a, k) in calls.items():
        outs = {}
        for threads in (1, args.threads):
            torch.set_num_threads(threads)
            outs[threads] = _leaves(plain[name](*a, **k))
        same = all(torch.equal(x, y) for x, y in zip(outs[1], outs[args.threads]))
        print(f"{name}: bitwise equal at 1 and {args.threads} threads: {same}")
    torch.set_num_threads(args.threads)
    got = run_summaries(run_vo(iter(frames), cfg, device="cpu"))
    want = ref["summaries"]
    ints = [7 + list(ref["summary_keys"]).index(k) for k in INT_KEYS]
    print(f"{args.threads} threads against {os.path.basename(REF)}: max pose difference "
          f"{np.abs(got[:, :7] - want[:, :7]).max():.3g}, frames with integer differences "
          f"{np.nonzero((got[:, ints] != want[:, ints]).any(axis=1))[0].tolist()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
