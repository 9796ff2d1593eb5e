"""Host driver loop (counterpart of ``stereo_vo_tpu/engine/driver.py``).

The replacement for ``vo_node``'s main loop (``vo_node.cpp:139-227``): drains a
frame stream through the drop gate, bootstraps on the first frame with enough
detections (retrying later frames otherwise), then steps every frame (streaming)
or replays whole chunks (offline replay), and collects poses + per-frame
metrics. No ROS: outputs are in-memory arrays plus optional trajectory files,
JSONL metrics, checkpoints, world-point dumps and feature-track debug images.
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
from stereo_vo_tpu_torch.engine.checkpoint import load_state, save_state
from stereo_vo_tpu_torch.engine.metrics import MetricsLogger
from stereo_vo_tpu_torch.engine.step import VOEngine, parse_summary


@dataclasses.dataclass
class VORun:
    poses: np.ndarray                 # [N, 7] published T_cw per processed frame
    gt_poses: Optional[np.ndarray]    # [N, 7] if the stream provides it
    frame_stats: List[dict]
    frames_per_sec: float             # after the first step / first chunk, host clock
    frame_seconds: List[float]        # per streamed step call, synchronized
    ate: Optional[dict]
    engine: VOEngine
    state: object                     # final VOState
    # per replayed chunk: dispatch to device completion, synchronized
    chunk_seconds: List[float] = dataclasses.field(default_factory=list)
    # chunks that missed the device-resident preload and were uploaded from
    # the host (0 whenever preload_device=True; >0 would flag a perf bug)
    preload_misses: int = 0
    # the engine's spans over the run, with trace=True
    # (utils/profiling.py::Trace)
    spans: Optional[object] = None


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def write_world_points(path: str, window) -> None:
    """One ``id x y z refcount`` row per live landmark of a window: the working
    equivalent of the reference's (disabled) ``/vo/features`` marker publisher
    (``vo_node.cpp:191-222``)."""
    valid = window.lm_valid.cpu().numpy()
    pos = window.lm_pos.cpu().numpy()[valid]
    refc = window.lm_refcount.cpu().numpy()[valid]
    ids = np.nonzero(valid)[0]
    with open(path, "w") as f:
        for i, p, rc in zip(ids, pos, refc):
            f.write(f"{i} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f} {rc}\n")


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
    save_track_images: int = 0,
    save_world_points: bool = False,
    progress: bool = False,
    engine: Optional[VOEngine] = None,
    device="cuda",
    trace: bool = False,
) -> VORun:
    """Run the full VO pipeline over a stereo stream.

    ``apply_drop_gate`` reproduces the reference's 0.05 s minimum inter-frame
    interval (``vo_node.cpp:124``); dataset replay at 11 Hz never triggers it.

    ``chunk_size > 1`` enables offline-replay mode: after bootstrap, frames are
    queued and each full chunk runs through ``VOEngine.replay_chunk``, whose
    poses and summaries the host fetches once per chunk; a tail shorter than
    a chunk goes through ``step``. ``preload_device`` uploads the whole
    sequence to the engine's device before the clock starts (one uint8
    ``[N, H, W]`` stack per eye). Online/streaming use keeps ``chunk_size = 0``
    (one call per frame, pose available immediately).

    ``checkpoint_every`` writes ``out_dir/checkpoint.npz`` every that many
    frames (streaming) or at the first chunk boundary past each multiple
    (chunked); ``resume_from`` loads one and skips the frames before its index.

    ``engine`` reuses an already-built ``VOEngine`` (a live source must not
    pay the first-frame warm-up mid-stream); otherwise one is built on
    ``device`` (``cuda`` unless the caller passes ``device="cpu"``).

    ``trace`` records the engine's spans (``VOEngine(..., trace=True)``; a
    given engine must have been built so) and drains them into
    ``VORun.spans`` at the end; with ``out_dir`` they are also written to
    ``out_dir/spans.json`` in the Chrome trace format
    (``utils/profiling.py::write_chrome_trace``).
    """
    it = iter(drop_gate(stream, config.runtime.drop_time) if apply_drop_gate else stream)

    first = next(it)
    if engine is None:
        engine = VOEngine(config, first.left.shape, device=device, trace=trace)
    elif trace and engine.recorder is None:
        raise ValueError("trace=True needs an engine built with trace=True")
    elif engine.image_shape != tuple(first.left.shape):
        raise ValueError(
            f"engine built for image shape {engine.image_shape}, "
            f"stream delivers {tuple(first.left.shape)}"
        )
    dev = engine.device

    if resume_from:
        state, start_idx = load_state(resume_from, engine)
    else:
        state = engine.init_state()
        start_idx = 0
    # read from the state once; then set by the bootstrap that succeeds
    initialized = bool(state.initialized)

    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    logger = MetricsLogger(os.path.join(out_dir, "metrics.jsonl")) if out_dir else None
    ckpt_path = os.path.join(out_dir, "checkpoint.npz") if out_dir else None

    poses: List[np.ndarray] = []
    gts: List[Optional[np.ndarray]] = []
    stats: List[dict] = []
    frame_seconds: List[float] = []
    chunk_seconds: List[float] = []

    n_done = 0
    t_start = None
    n_timed_from = 0
    frame = first
    # Device-resident sequence in preload mode (uploaded once, before the
    # clock starts). ONE [N, H, W] stack per eye, sliced per chunk through a
    # frame-index -> position map, so chunk grouping needs no alignment
    # assumption: bootstrap may succeed on any frame (the reference just
    # retries the next frame, image_processor.cpp:23-25) and every chunk
    # still hits device memory.
    preload = None          # (pos_by_index, lefts_all, rights_all)
    preload_misses = 0      # chunks that fell back to a host upload

    if preload_device and chunk_size > 1:
        frames_all = [first] + list(it)
        if max_frames is not None:
            frames_all = frames_all[: max_frames + 1]
        it = iter(frames_all[1:])
        if len(frames_all) > chunk_size:
            pos_by_index = {f.index: i for i, f in enumerate(frames_all)}
            lefts_all = torch.from_numpy(np.stack([f.left for f in frames_all])).to(dev)
            rights_all = torch.from_numpy(np.stack([f.right for f in frames_all])).to(dev)
            preload = (pos_by_index, lefts_all, rights_all)
            _sync(dev)

    def record(frame_index, pose, row, gt, allow_ckpt=True):
        nonlocal n_done
        row = {"frame": int(frame_index), **row}
        poses.append(np.asarray(pose))
        gts.append(gt)
        stats.append(row)
        if logger:
            logger.log(row)
        if progress and n_done % 20 == 0:
            print(
                f"[vo] frame {frame_index}: kf={row['is_keyframe']} "
                f"tracked={row['num_tracked']} inliers={row['num_inliers']}"
            )
        n_done += 1
        if allow_ckpt and checkpoint_every and out_dir and n_done % checkpoint_every == 0:
            save_state(ckpt_path, state, frame_index + 1)

    def dump_world_points(st, frame_index):
        """The live landmark table, per keyframe (streaming) / per chunk end
        (chunked)."""
        if not (save_world_points and out_dir):
            return
        wdir = os.path.join(out_dir, "world_points")
        os.makedirs(wdir, exist_ok=True)
        write_world_points(os.path.join(wdir, f"points_{frame_index:06d}.txt"), st.window)

    pending_chunk: List = []
    # Dispatched-but-undrained chunk results. Eager mode (any per-chunk
    # consumer active: checkpoints, world points, metrics logger, progress)
    # holds at most one entry: the previous chunk is fetched only after the
    # next is dispatched. Deferred mode (pure offline replay, nothing consumes
    # results mid-run) holds ALL chunks and fetches once at the end.
    inflight: List = []  # [(frames, poses_dev, summaries_dev, state_after)]
    defer_fetch = not (
        checkpoint_every or save_world_points or progress or logger is not None
    )

    def drain_inflight():
        nonlocal inflight
        entries, inflight = inflight, []
        for fr, poses_dev, summ_dev, state_after in entries:
            ch_poses = poses_dev.cpu().numpy()
            ch_summaries = summ_dev.cpu().numpy()
            n_before = n_done
            any_kf = False
            for f, pose, summ in zip(fr, ch_poses, ch_summaries):
                _, row = parse_summary(summ)
                any_kf = any_kf or row["is_keyframe"]
                # chunked mode checkpoints only at chunk boundaries: by drain
                # time the nonlocal `state` already reflects the NEXT
                # dispatched chunk, so the per-frame checkpoint in record()
                # would pair a too-new state with a too-old resume index
                # (duplicating frames on resume)
                record(f.index, pose, row, f.gt_pose, allow_ckpt=False)
            if any_kf and state_after is not None:
                dump_world_points(state_after, fr[-1].index)
            if (
                checkpoint_every
                and out_dir
                and (n_done // checkpoint_every) > (n_before // checkpoint_every)
            ):
                # state_after is the state at the END of this drained chunk
                # (captured at dispatch), matching resume index fr[-1].index+1
                save_state(ckpt_path, state_after, fr[-1].index + 1)

    def stream_step(f):
        """One streamed bootstrap/step call: returns the step output and its
        summary on the host, whose fetch is the frame's one wait for the
        device; the frame's time to that fetch goes to ``frame_seconds``. A
        bootstrap that reports a keyframe sets ``initialized``."""
        nonlocal state, initialized
        booting = not initialized
        fn = engine.bootstrap if booting else engine.step
        t0 = time.perf_counter()
        state, out = fn(state, f.left, f.right)
        pose, row = parse_summary(out.summary)
        frame_seconds.append(time.perf_counter() - t0)
        if booting and row["is_keyframe"]:
            initialized = True
        return out, pose, row

    def flush_chunk(allow_partial=False):
        nonlocal state, preload_misses, t_start, n_timed_from
        if chunk_size > 1 and len(pending_chunk) == chunk_size:
            t0 = time.perf_counter()
            pos = preload[0].get(pending_chunk[0].index) if preload else None
            if pos is not None and pos + chunk_size <= len(preload[0]):
                lefts = preload[1][pos:pos + chunk_size]
                rights = preload[2][pos:pos + chunk_size]
            else:
                if preload is not None:
                    preload_misses += 1
                lefts = np.stack([f.left for f in pending_chunk])
                rights = np.stack([f.right for f in pending_chunk])
            state, ch_poses, ch_summaries = engine.replay_chunk(state, lefts, rights)
            _sync(dev)
            chunk_seconds.append(time.perf_counter() - t0)
            chunk_frames = list(pending_chunk)
            pending_chunk.clear()
            if t_start is None:
                # time from the end of the first chunk on (its first steps
                # pay the device's warm-up)
                t_start = time.perf_counter()
                n_timed_from = n_done + len(chunk_frames)
            if not defer_fetch:
                drain_inflight()
            inflight.append(
                (chunk_frames, ch_poses, ch_summaries,
                 state if not defer_fetch else None)
            )
        elif allow_partial and pending_chunk:
            # tail shorter than chunk_size: run it through the streaming step
            drain_inflight()
            for f in list(pending_chunk):
                _, pose, row = stream_step(f)
                record(f.index, pose, row, f.gt_pose)
                if row["is_keyframe"]:
                    dump_world_points(state, f.index)
            pending_chunk.clear()

    while True:
        n_seen = (n_done + len(pending_chunk)
                  + sum(len(e[0]) for e in inflight))
        if max_frames is not None and n_seen >= max_frames:
            break
        if frame.index >= start_idx:
            if chunk_size > 1 and initialized:
                pending_chunk.append(frame)
                if len(pending_chunk) >= chunk_size:
                    flush_chunk()
            else:
                was_initialized = initialized
                out, pose, row = stream_step(frame)
                if t_start is None and was_initialized:
                    # steady-state rate: from the end of the first step on
                    t_start = time.perf_counter()
                    n_timed_from = n_done + 1
                if (
                    save_track_images
                    and out_dir
                    and frame.index % save_track_images == 0
                ):
                    # the /feature_tracking debug image (vo_node.cpp:188-189)
                    from stereo_vo_tpu_torch.eval.viz import draw_tracks, write_image

                    img = draw_tracks(
                        frame.left, out.track_from.cpu().numpy(),
                        out.track_to.cpu().numpy(), out.track_valid.cpu().numpy(),
                    )
                    write_image(os.path.join(out_dir, f"tracks_{frame.index:06d}.png"), img)
                record(frame.index, pose, row, frame.gt_pose)
                if row["is_keyframe"]:
                    dump_world_points(state, frame.index)
        try:
            frame = next(it)
        except StopIteration:
            break
    flush_chunk(allow_partial=True)
    if defer_fetch:
        # every chunk was synchronized at dispatch, so the device is done:
        # the bulk result fetch below is host transport, not replay time
        elapsed = time.perf_counter() - t_start if t_start else 0.0
        drain_inflight()
    else:
        # eager mode: the final chunk is still undrained; record it inside
        # the timed region, as every earlier chunk was
        drain_inflight()
        elapsed = time.perf_counter() - t_start if t_start else 0.0
    engine.flush_launches()
    spans = engine.trace_records() if trace else None
    n_timed = max(n_done - n_timed_from, 0) if t_start else 0
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
        if spans is not None:
            from stereo_vo_tpu_torch.utils.profiling import write_chrome_trace

            write_chrome_trace(spans, os.path.join(out_dir, "spans.json"))
        if logger:
            logger.close()

    return VORun(
        poses=poses_arr, gt_poses=gt_arr, frame_stats=stats, frames_per_sec=fps,
        frame_seconds=frame_seconds, ate=ate, engine=engine, state=state,
        chunk_seconds=chunk_seconds, preload_misses=preload_misses, spans=spans,
    )
