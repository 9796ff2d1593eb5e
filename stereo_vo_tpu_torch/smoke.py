"""Device smoke gate of the PyTorch port: ``python -m stereo_vo_tpu_torch.smoke``
(counterpart of ``stereo_vo_tpu/smoke.py``).

Runs the real hot paths on ``--device`` (default ``cuda``): bootstrap, three
streamed steps, and one 16-frame replayed chunk of a 376x1241 synthetic
``kitti00`` world, then prints one PASS/FAIL line. A green CPU test suite does
not run the CUDA kernel; this does.

Exit code 0 on pass, 1 on failure or when the device is not available.
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m stereo_vo_tpu_torch.smoke")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    t0 = time.time()

    import numpy as np
    import torch

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print(f"[smoke] FAIL device={args.device}: no CUDA device is available")
        return 1

    from stereo_vo_tpu_torch.core.config import load_config
    from stereo_vo_tpu_torch.data.synthetic import SyntheticStereoSequence
    from stereo_vo_tpu_torch.engine.driver import run_vo
    from stereo_vo_tpu_torch.engine.step import VOEngine, parse_summary

    cfg = load_config("kitti00")
    world = SyntheticStereoSequence(
        cam=cfg.camera, n_frames=20, shape=(376, 1241), n_points=3000,
        seed=0, speed=0.8, yaw_rate=0.003,
    )
    frames = list(world)

    # 1) streamed path: bootstrap + 3 steps (vo_node.cpp:139-227 analog)
    engine = VOEngine(cfg, frames[0].left.shape, device=dev)
    state, _ = engine.bootstrap(engine.init_state(), frames[0].left, frames[0].right)
    for f in frames[1:4]:
        state, out = engine.step(state, f.left, f.right)
        parse_summary(out.summary)

    # 2) chunked replay: one 16-frame chunk (the bench path)
    run = run_vo(iter(frames[:17]), cfg, chunk_size=16, preload_device=True, engine=engine)
    n = len(run.poses)
    finite = bool(np.isfinite(run.poses).all())
    kf = sum(1 for s in run.frame_stats if s["is_keyframe"])
    ok = n == 17 and finite and kf >= 1 and len(run.chunk_seconds) == 1

    dt = time.time() - t0
    status = "PASS" if ok else "FAIL"
    print(
        f"[smoke] {status} device={dev} frames={n} keyframes={kf} "
        f"finite={finite} wall={dt:.1f}s"
    )
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
