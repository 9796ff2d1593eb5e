#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (``stereo_vo_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA device and ``nvcc``.
It needs one card, no network and no arguments, and it imports nothing of
JAX or of the JAX package. Phases, each fatal on failure:

1. device: print the card (``nvidia-smi`` name and power limit) and the
   CUDA version; switch TF32 off;
2. build: compile ``stereo_vo_tpu_torch/csrc/extract_regions.cu`` with nvcc
   and print the build seconds and what ptxas reports;
3. kernel check: the region-extraction kernel against its plain PyTorch
   version (``extract_regions_ref``) at the shapes the main path gives it,
   bitwise (``torch.equal``: a copy has no rounding), then both timed with
   CUDA events (median of 20 samples);
4. main path: ``run_vo`` over a 20-frame synthetic KITTI-sized world
   (376x1241, ``kitti00`` intrinsics, default capacities) on ``cuda``, with
   the kernel's launch counter zeroed just before and read just after; it
   checks the poses (20, finite), at least 2 keyframes after bootstrap, the
   median tracked count over the steps (> 50), PnP on every accepted frame,
   at least 2 kernel launches per LK level pass, and the aligned keyframe
   ATE.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
package beside it, the script exits non-zero before printing any result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

# aligned keyframe ATE bound (m): twice what the port gives for the same 20
# frames on the CPU (rmse 0.0784 m, PyTorch 2.13 CPU build)
ATE_BOUND_M = 0.1568
N_FRAMES = 20
IMAGE_SHAPE = (376, 1241)

# (label, padded image H, W, region rows, cols, features): LK inner levels
# (56x56, pad 22) and the top level (88x88, pad 38) at the compacted (160)
# and full (448) widths; the BM left window (32x32) and right search band
# (32x80, pad 66) at the compacted (320) and full widths; and the JAX
# package's own extraction-test shapes
SHAPES = [
    ("lk_l0_56_n160", 376 + 44, 1241 + 44, 56, 56, 160),
    ("lk_l0_56_n448", 376 + 44, 1241 + 44, 56, 56, 448),
    ("lk_l1_56_n160", 188 + 44, 621 + 44, 56, 56, 160),
    ("lk_top_88_n160", 47 + 76, 156 + 76, 88, 88, 160),
    ("lk_top_88_n448", 47 + 76, 156 + 76, 88, 88, 448),
    ("lk_hint_top_88_n160", 188 + 76, 621 + 76, 88, 88, 160),
    ("bm_left_32x32_n320", 376 + 132, 1241 + 132, 32, 32, 320),
    ("bm_right_32x80_n320", 376 + 132, 1241 + 132, 32, 80, 320),
    ("bm_left_32x32_n768", 376 + 132, 1241 + 132, 32, 32, 768),
    ("bm_right_32x80_n768", 376 + 132, 1241 + 132, 32, 80, 768),
    ("img_384x1256_r88", 384, 1256, 88, 88, 64),
    ("img_96x320_r48", 96, 320, 48, 48, 64),
]
TIMED = ("lk_l0_56_n160", "lk_top_88_n160", "bm_left_32x32_n320", "bm_right_32x80_n320")
HEADLINE = "lk_l0_56_n160"


def _log(msg: str) -> None:
    print(msg, flush=True)


def _check(ok: bool, what) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def _inputs(torch, gen, hp, wp, ry, rx, n, device):
    """A random image and origins: both image corners, origins past each edge
    (the clamp pulls them in), the rest 8-aligned like the callers' or not."""
    stack = torch.rand((1, hp, wp), generator=gen, device="cpu") * 255.0
    ox = torch.randint(0, wp - rx + 1, (n,), generator=gen)
    oy = torch.randint(0, hp - ry + 1, (n,), generator=gen)
    ox[n // 2:] = ox[n // 2:] // 8 * 8
    oy[n // 2:] = oy[n // 2:] // 8 * 8
    ox[0], oy[0] = 0, 0
    ox[1], oy[1] = wp - rx, hp - ry
    ox[2], oy[2] = wp - rx + 9, hp - ry + 5
    ox[3], oy[3] = -5, -11
    origins = torch.stack([ox, oy], dim=1).to(torch.int32)
    return stack.to(device).contiguous(), origins.to(device).contiguous()


def _time_ms(torch, fn, samples=20, inner=10):
    """Median over ``samples`` of the mean time of ``inner`` back-to-back
    calls, by CUDA events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    from stereo_vo_tpu_torch import cuda_build
    from stereo_vo_tpu_torch.core.config import load_config
    from stereo_vo_tpu_torch.data.synthetic import SyntheticStereoSequence
    from stereo_vo_tpu_torch.engine.driver import run_vo
    from stereo_vo_tpu_torch.eval.ate import absolute_trajectory_error
    from stereo_vo_tpu_torch.ops.regions import extract_regions, extract_regions_ref

    # ---- 1. device
    smi = _nvidia_smi()
    _log(f"nvidia-smi: {smi}")
    _log(f"torch {torch.__version__} cuda {torch.version.cuda} "
         f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")

    # ---- 2. build
    t0 = time.perf_counter()
    cuda_build.load("extract_regions")
    build_s = time.perf_counter() - t0
    _log(f"build: extract_regions.cu {build_s:.2f} s "
         f"(nvcc {cuda_build.build_seconds.get('extract_regions', 0.0):.2f} s)")
    for line in cuda_build.build_log.get("extract_regions", "").splitlines():
        _log(f"  ptxas: {line.strip()}")

    # ---- 3. kernel against its plain version
    gen = torch.Generator(device="cpu").manual_seed(0)
    max_err = 0.0
    timings = {}
    for label, hp, wp, ry, rx, n in SHAPES:
        stack, origins = _inputs(torch, gen, hp, wp, ry, rx, n, dev)
        got = extract_regions(stack, origins, ry, rx)
        torch.cuda.synchronize()
        want = extract_regions_ref(stack, origins, ry, rx)
        torch.cuda.synchronize()
        _check(got.shape == (n, 1, ry, rx) and torch.equal(got, want),
               f"kernel equals the plain version at {label}")
        max_err = max(max_err, float((got - want).abs().max()))
        if label in TIMED:
            k_ms = _time_ms(torch, lambda: extract_regions(stack, origins, ry, rx))
            p_ms = _time_ms(torch, lambda: extract_regions_ref(stack, origins, ry, rx))
            timings[label] = (k_ms, p_ms)
            mb = 2 * n * ry * rx * 4 / 1e6
            _log(f"time {label}: kernel {k_ms * 1e3:.1f} us  plain {p_ms * 1e3:.1f} us  "
                 f"({mb:.2f} MB moved, {mb / 1e3 / (k_ms / 1e3):.1f} GB/s by the kernel)")
        _log(f"check {label}: [{n}, 1, {ry}, {rx}] from [1, {hp}, {wp}] bitwise equal")

    # ---- 4. the main path
    cfg = load_config("kitti00")
    world = SyntheticStereoSequence(
        cam=cfg.camera, n_frames=N_FRAMES, shape=IMAGE_SHAPE, n_points=4000, seed=0,
        speed=0.8, yaw_rate=0.003,
    )
    extract_regions.launches = 0
    t0 = time.perf_counter()
    run = run_vo(world, cfg, device=dev)
    wall_s = time.perf_counter() - t0
    launches = extract_regions.launches

    stats = run.frame_stats
    for s in stats:
        _log("frame " + json.dumps(s))
    kf = np.array([s["is_keyframe"] for s in stats])
    first_kf = int(np.argmax(kf))
    steps = stats[first_kf + 1:]
    lk_passes = sum(cfg.frontend.lk_hint_levels if s["hinted"] else cfg.frontend.lk_max_level + 1
                    for s in steps)
    ate_kf = absolute_trajectory_error(run.poses[kf], world.gt_poses[kf], align=True)
    step_ms = [1e3 * t for t in run.frame_seconds[first_kf + 1:]]
    _log(f"main path: {len(run.poses)} frames in {wall_s:.2f} s (incl. rendering), "
         f"{run.frames_per_sec:.2f} frames/s after the first step, "
         f"step ms p50 {statistics.median(step_ms):.1f} max {max(step_ms):.1f}")
    _log(f"keyframes {int(kf.sum())}, aligned keyframe ATE rmse {ate_kf['rmse']:.4f} m "
         f"(bound {ATE_BOUND_M} m), all-frames ATE rmse {run.ate['rmse']:.4f} m")
    _log(f"extract_regions launches {launches} over {lk_passes} LK level passes "
         f"and {int(kf.sum())} keyframes")

    _check(len(run.poses) == N_FRAMES, f"{len(run.poses)} poses")
    _check(bool(np.all(np.isfinite(run.poses))), "non-finite pose")
    _check(int(kf[first_kf + 1:].sum()) >= 2, "fewer than 2 keyframes after bootstrap")
    tracked = [s["num_tracked"] for s in steps]
    _check(statistics.median(tracked) > 50, f"median tracked count of {tracked}")
    _check(all(s["pnp_ok"] for s in stats), "PnP failed on an accepted frame")
    _check(launches >= 2 * lk_passes > 0, f"{launches} launches for {lk_passes} LK passes")
    _check(ate_kf["rmse"] < ATE_BOUND_M, f"keyframe ATE {ate_kf}")

    k_ms, p_ms = timings[HEADLINE]
    print(json.dumps({"kernels": [{
        "name": "extract_regions",
        "route": "cuda",
        "source": "stereo_vo_tpu_torch/csrc/extract_regions.cu",
        "replaces": "stereo_vo_tpu/ops/pallas_extract.py:168",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": k_ms,
        "plain_ms": p_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
