"""Host driver loop, streaming path (counterpart of
``stereo_vo_tpu/engine/driver.py::run_vo`` with ``chunk_size=0``).

Drains a frame stream (optionally through the 0.05 s drop gate), bootstraps
on the first frame with enough detections (retrying later frames otherwise),
steps every following frame, and collects the published poses, per-frame
stats, frames/s after the first step, ATE when the stream carries ground
truth, and KITTI/TUM trajectory files when ``out_dir`` is set.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import List, Optional

import numpy as np
import torch

from stereo_vo_tpu_torch.core.config import PipelineConfig
from stereo_vo_tpu_torch.data.stream import drop_gate
from stereo_vo_tpu_torch.engine.step import VOEngine, parse_summary


@dataclasses.dataclass
class VORun:
    poses: np.ndarray                 # [N, 7] published T_cw per processed frame
    gt_poses: Optional[np.ndarray]    # [N, 7] if the stream provides it
    frame_stats: List[dict]
    frames_per_sec: float             # after the first step, host clock
    frame_seconds: List[float]        # per step call, synchronized
    ate: Optional[dict]
    engine: VOEngine
    state: object                     # final VOState


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_vo(
    stream,
    config: PipelineConfig,
    out_dir: Optional[str] = None,
    max_frames: Optional[int] = None,
    apply_drop_gate: bool = False,
    checkpoint_every: int = 0,
    resume_from: Optional[str] = None,
    chunk_size: int = 0,
    preload_device: bool = False,
    progress: bool = False,
    engine: Optional[VOEngine] = None,
    device="cpu",
) -> VORun:
    """Run the VO pipeline over a stereo stream, one step call per frame.

    Chunked replay, checkpoint/resume and device preloading belong to the
    reference's offline replay path and are not ported yet; asking for them
    raises ``NotImplementedError``.
    """
    if chunk_size > 1:
        raise NotImplementedError(
            "run_vo: chunked replay (chunk_size > 1) is not ported yet (ROADMAP Queue 1, item 11)")
    if resume_from:
        raise NotImplementedError(
            "run_vo: resume_from needs engine/checkpoint.py, not ported yet (ROADMAP Queue 1, item 10)")
    if checkpoint_every:
        raise NotImplementedError(
            "run_vo: checkpoint_every needs engine/checkpoint.py, not ported yet "
            "(ROADMAP Queue 1, item 10)")
    if preload_device:
        raise NotImplementedError(
            "run_vo: preload_device belongs to chunked replay, not ported yet (ROADMAP Queue 1, item 11)")

    it = iter(drop_gate(stream, config.runtime.drop_time) if apply_drop_gate else stream)
    first = next(it)
    if engine is None:
        engine = VOEngine(config, first.left.shape, device=device)
    elif engine.image_shape != tuple(first.left.shape):
        raise ValueError(
            f"engine built for image shape {engine.image_shape}, "
            f"stream delivers {tuple(first.left.shape)}"
        )
    dev = engine.device
    state = engine.init_state()
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)

    poses: List[np.ndarray] = []
    gts: List[Optional[np.ndarray]] = []
    stats: List[dict] = []
    frame_seconds: List[float] = []
    t_start = None
    n_timed_from = 0
    frame = first
    while True:
        if max_frames is not None and len(poses) >= max_frames:
            break
        initialized = bool(state.initialized)
        fn = engine.step if initialized else engine.bootstrap
        t0 = time.perf_counter()
        state, out = fn(state, frame.left, frame.right)
        pose, row = parse_summary(out.summary)      # fetch: ends the frame's work
        _sync(dev)
        frame_seconds.append(time.perf_counter() - t0)
        if t_start is None and initialized:
            # steady-state rate: from the end of the first step on
            t_start = time.perf_counter()
            n_timed_from = len(poses) + 1
        row = {"frame": int(frame.index), **row}
        poses.append(np.asarray(pose))
        gts.append(frame.gt_pose)
        stats.append(row)
        if progress and len(poses) % 20 == 1:
            print(f"[vo] frame {frame.index}: kf={row['is_keyframe']} "
                  f"tracked={row['num_tracked']} inliers={row['num_inliers']}")
        try:
            frame = next(it)
        except StopIteration:
            break
    elapsed = time.perf_counter() - t_start if t_start else 0.0
    n_timed = max(len(poses) - n_timed_from, 0) if t_start else 0
    fps = n_timed / elapsed if elapsed > 0 and n_timed > 0 else 0.0

    poses_arr = np.stack(poses) if poses else np.zeros((0, 7), np.float32)
    gt_arr = np.stack(gts) if gts and all(g is not None for g in gts) else None
    ate = None
    if gt_arr is not None and len(poses_arr) >= 3:
        from stereo_vo_tpu_torch.eval.ate import absolute_trajectory_error

        ate = absolute_trajectory_error(poses_arr, gt_arr, align=True)
    if out_dir:
        from stereo_vo_tpu_torch.eval.trajectory import (
            write_kitti_trajectory,
            write_tum_trajectory,
        )

        write_kitti_trajectory(os.path.join(out_dir, "trajectory_kitti.txt"), poses_arr)
        write_tum_trajectory(os.path.join(out_dir, "trajectory_tum.txt"), poses_arr)

    return VORun(
        poses=poses_arr, gt_poses=gt_arr, frame_stats=stats, frames_per_sec=fps,
        frame_seconds=frame_seconds, ate=ate, engine=engine, state=state,
    )
