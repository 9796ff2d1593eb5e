"""The per-frame VO step (counterpart of ``stereo_vo_tpu/engine/step.py``).

``VOEngine.bootstrap`` seeds the tracker and window from the first frame with
enough detections; ``VOEngine.step`` runs one frame: the every-frame
detection-count bail, fused forward/backward LK tracking, the
parallax/lost keyframe gate, PnP on accepted frames, and on keyframes
detection, dedup, sparse StereoBM, triangulation, the window update and the
Schur-LM solve.

The step takes the reference's decisions in the reference's order, each a
``lax.cond`` there and ``engine/graphs.py::cond`` here: the tracker's hinted
or full pyramid, PnP on an accepted frame, the keyframe work when PnP holds,
and the compacted or the full solve. Everything else is computed
unconditionally and selected with ``torch.where``, as the reference's
``sel`` does. With ``graphs=True`` (the default on ``cuda``) the whole step
is one ``graphs.Program``: captured at its first use, then replayed as one
CUDA graph whose decisions are conditional nodes, with no host read; the
carried state lives in the program's buffers. ``graphs=False`` runs the same
code eagerly, reading each predicate once on the host: the CPU's path, and
the card's reference for the graph.

The PnP hypotheses are the reference's own ``jax.random`` draw, recomputed
bit for bit from the frame index (``frontend/prng.py``);
``step(..., pnp_indices=...)`` injects others instead.

``VOEngine.replay_chunk`` is the offline-replay path (the reference's
``lax.scan``): the state-independent preprocessing of a ``[K, H, W]`` chunk
runs as one batched pass, then each frame is one step on its slice; on the
card, one replay of the step program per frame, with no host read between
frames, and the state and the stacked outputs handed out once at the end.

``VOEngine(..., trace=True)`` records the engine's spans
(``utils/profiling.py::Recorder``): host spans around ``step``
(``step.enqueue``), ``bootstrap`` and ``replay_chunk``, and device stamps
around each call's device work (``step``, ``bootstrap``, ``preprocess``)
and, inside the step graph and its conditional bodies, around
``track_step`` (``track``), the PnP body (``pnp``), the keyframe-prep body
(``kf_prep``) and ``bundle_adjust`` in the solve body (``ba``).
``trace_records()`` drains them. With ``trace=False`` (the default) no stamp
is captured or launched.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from stereo_vo_tpu_torch.backend.schur import bundle_adjust, compaction_applies
from stereo_vo_tpu_torch.backend.window import (
    WindowState,
    add_keyframe,
    empty_window,
    get_world_points,
    newest_pose,
    valid_first,
)
from stereo_vo_tpu_torch.core import geometry as geo
from stereo_vo_tpu_torch.core.config import PipelineConfig
from stereo_vo_tpu_torch.core.consts import const
from stereo_vo_tpu_torch.core.f32 import sqrt_f32
from stereo_vo_tpu_torch.engine import graphs as graphs_module
from stereo_vo_tpu_torch.engine.graphs import cond
from stereo_vo_tpu_torch.frontend.detect import dedup_new_features, detect_features
from stereo_vo_tpu_torch.frontend.pnp import PnPResult, pnp_ransac
from stereo_vo_tpu_torch.frontend.track import NO_FLOW, TrackerState, track_step, tracker_init
from stereo_vo_tpu_torch.frontend.triangulate import triangulate_from_disparities
from stereo_vo_tpu_torch.ops.pyramid import build_pyramid
from stereo_vo_tpu_torch.ops.shi_tomasi import count_quality_peaks, min_eig_response
from stereo_vo_tpu_torch.ops.stereo_bm import stereo_bm_at
from stereo_vo_tpu_torch.utils.profiling import Recorder, Trace


class VOState(NamedTuple):
    tracker: TrackerState
    window: WindowState
    pnp_pose: torch.Tensor      # [7] PnP warm start
    cur_pose: torch.Tensor      # [7] latest published T_cw (BA-optimized)
    frame_idx: torch.Tensor     # [] int32
    initialized: torch.Tensor   # [] bool


SUMMARY_KEYS = (
    "is_keyframe", "pnp_ok", "num_detected", "num_tracked", "num_inliers",
    "num_new_landmarks", "av_parallax", "percent_lost", "ba_initial_cost",
    "ba_final_cost", "ba_iterations", "hinted",
)


class StepOutput(NamedTuple):
    pose_cw: torch.Tensor       # [7] published pose (T_cw)
    pose_wc: torch.Tensor       # [7] inverted for the path
    is_keyframe: torch.Tensor
    pnp_ok: torch.Tensor
    num_detected: torch.Tensor
    num_tracked: torch.Tensor
    num_inliers: torch.Tensor
    num_new_landmarks: torch.Tensor
    av_parallax: torch.Tensor
    percent_lost: torch.Tensor
    ba_initial_cost: torch.Tensor
    ba_final_cost: torch.Tensor
    ba_iterations: torch.Tensor
    hinted: torch.Tensor        # this step ran the flow-hinted short pyramid
    track_from: torch.Tensor    # [F, 2]
    track_to: torch.Tensor      # [F, 2]
    track_valid: torch.Tensor   # [F]
    # the pose and every per-frame scalar (SUMMARY_KEYS order) in one float32
    # vector [19], so the host fetches one buffer per frame
    summary: Optional[torch.Tensor] = None


def _with_summary(out: StepOutput) -> StepOutput:
    scalars = torch.stack([getattr(out, k).to(torch.float32) for k in SUMMARY_KEYS])
    return out._replace(summary=torch.cat([out.pose_cw.to(torch.float32), scalars]))


def parse_summary(vec) -> Tuple[np.ndarray, dict]:
    """Host-side: unpack a summary vector into ``(pose [7], metrics row)``."""
    if isinstance(vec, torch.Tensor):
        vec = vec.detach().cpu().numpy()
    vec = np.asarray(vec)
    row = {}
    for i, k in enumerate(SUMMARY_KEYS):
        v = float(vec[7 + i])
        if k in ("is_keyframe", "pnp_ok", "hinted"):
            row[k] = bool(v)
        elif k.startswith("num_") or k == "ba_iterations":
            row[k] = int(v)
        else:
            row[k] = v
    return vec[:7], row


def _pad_to(arr: torch.Tensor, n: int) -> torch.Tensor:
    if arr.shape[0] >= n:
        return arr[:n]
    out = torch.zeros((n,) + tuple(arr.shape[1:]), dtype=arr.dtype, device=arr.device)
    out[: arr.shape[0]] = arr
    return out


def _norm2(v: torch.Tensor) -> torch.Tensor:
    return sqrt_f32(torch.sum(v * v, dim=-1))


def _stereo_weight(fb: float, z: torch.Tensor, sigma_d: float) -> torch.Tensor:
    """Stereo depth-noise prior weight ``(f b / (max(z, 1)^2 sigma_d))^2``."""
    return (torch.full_like(z, fb) / (torch.clamp(z, min=1.0) ** 2 * sigma_d)) ** 2


# the torch.profiler range around the frames of a replayed chunk, from the
# first frame's step to the last one's
CHUNK_RANGE = "VOEngine.replay_chunk.frames"
# a device span site with tracing off
_NO_SPAN = contextlib.nullcontext()


class VOEngine:
    """Bootstrap/step functions closed over one config, image shape and device
    (``cuda`` unless the caller passes ``device="cpu"``).

    ``graphs``: run the step as one device program replayed from a CUDA
    graph (module docstring); ``None`` means ``True`` on ``cuda`` and
    ``False`` elsewhere, and ``True`` off ``cuda`` raises. ``programs``
    holds the captured step programs, one per input signature (a streamed
    frame, a chunk's frame, an injected PnP draw; each image shape its own).
    A state or output that ``step`` hands out in graph mode is the
    program's buffers: valid until the engine's next call.

    ``trace``: record the engine's spans (module docstring) in
    ``recorder``, drained by ``trace_records()``; ``recorder`` is None
    without it.

    TF32 is switched off for both matmuls and cuDNN: the port matches the
    reference in float32."""

    def __init__(self, config: PipelineConfig, image_shape: Tuple[int, int],
                 device="cuda", graphs: Optional[bool] = None, trace: bool = False):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.config = config
        self.image_shape = tuple(image_shape)
        self.device = torch.device(device)
        if graphs is None:
            graphs = self.device.type == "cuda"
        if graphs and self.device.type != "cuda":
            raise ValueError(f"graphs=True needs a CUDA device, not {self.device}")
        self.graphs = bool(graphs)
        self.programs: Dict[tuple, graphs_module.Program] = {}
        self.recorder: Optional[Recorder] = Recorder(self.device) if trace else None

    def trace_records(self) -> Trace:
        """The spans recorded since the last call (``utils/profiling.py::
        Trace``: each with its call, frame, parent and self time, the records
        dropped, the device's idle time by host span), on the host clock;
        one synchronize and one read back. Call it between the engine's
        calls."""
        if self.recorder is None:
            raise ValueError("tracing is off: build the engine with trace=True")
        return self.recorder.drain()

    def _span(self, name: str, frame=None):
        """The device span ``name`` around a block (nothing without tracing)."""
        rec = self.recorder
        return _NO_SPAN if rec is None else rec.span(name, frame)

    def flush_launches(self) -> None:
        """Add what the programs' replays launched (counted on the device)
        to the hand kernels' wrappers' counts: one read back per program."""
        for program in self.programs.values():
            program.flush_launches()

    def _image(self, img) -> torch.Tensor:
        """A host or device image as float32 on the engine's device (uint8
        images cross to the device before the conversion)."""
        return self._upload(img).to(torch.float32)

    def _upload(self, img) -> torch.Tensor:
        """A host or device image on the engine's device, in its own dtype. A
        host image crosses to the card through pinned memory, without a
        wait."""
        if not isinstance(img, torch.Tensor):
            img = torch.from_numpy(np.ascontiguousarray(img))
        if img.device == self.device:
            return img
        if self.device.type == "cuda" and img.device.type == "cpu":
            return img.pin_memory().to(self.device, non_blocking=True)
        return img.to(self.device)

    def _scalar(self, value, dtype) -> torch.Tensor:
        """A constant 0-d tensor on the engine's device, made once; callers
        never write into it."""
        return const(value, dtype, self.device)

    # ------------------------------------------------------------------
    def init_state(self) -> VOState:
        cfg = self.config
        dev = self.device
        h, w = self.image_shape
        f_cap = cfg.backend.feature_capacity
        pyr_shapes = []
        hh, ww = h, w
        for _ in range(cfg.frontend.lk_max_level + 1):
            pyr_shapes.append((hh, ww))
            hh, ww = (hh + 1) // 2, (ww + 1) // 2
        tracker = TrackerState(
            pyramid=tuple(torch.zeros(s, dtype=torch.float32, device=dev) for s in pyr_shapes),
            feat_xy=torch.zeros((f_cap, 2), dtype=torch.float32, device=dev),
            feat_ids=torch.zeros((f_cap,), dtype=torch.int32, device=dev),
            feat_valid=torch.zeros((f_cap,), dtype=torch.bool, device=dev),
            init_xy=torch.zeros((f_cap, 2), dtype=torch.float32, device=dev),
            init_count=self._scalar(0, torch.int32),
            flow_xy=torch.zeros((f_cap, 2), dtype=torch.float32, device=dev),
            flow_valid=torch.zeros((f_cap,), dtype=torch.bool, device=dev),
            pred_err=self._scalar(NO_FLOW, torch.float32),
        )
        return VOState(
            tracker=tracker,
            window=empty_window(cfg.backend, device=dev),
            pnp_pose=geo.pose_identity(device=dev),
            cur_pose=geo.pose_identity(device=dev),
            frame_idx=self._scalar(0, torch.int32),
            initialized=self._scalar(False, torch.bool),
        )

    def _bm(self, left_f, right_f, xy, valid, compact_slots=0):
        fc = self.config.frontend
        return stereo_bm_at(
            left_f, right_f, xy, valid,
            num_disparities=fc.bm_num_disparities, block_size=fc.bm_block_size,
            prefilter_cap=fc.bm_prefilter_cap,
            texture_threshold=fc.bm_texture_threshold,
            uniqueness_ratio=fc.bm_uniqueness_ratio,
            compact_slots=compact_slots,
        )

    # ------------------------------------------------------------------
    def bootstrap(self, state: VOState, left, right) -> Tuple[VOState, StepOutput]:
        """First-keyframe path: triangulate the detections at the identity pose
        and seed tracker + window."""
        rec = self.recorder
        if rec is None:
            return self._bootstrap(state, left, right)
        return rec.call("bootstrap", "bootstrap", state.frame_idx, self._bootstrap, state, left,
                        right)

    def _bootstrap(self, state: VOState, left, right) -> Tuple[VOState, StepOutput]:
        cfg = self.config
        f_cap = cfg.backend.feature_capacity
        left_f = self._image(left)
        det_xy, det_valid = detect_features(left_f, cfg.frontend)
        n_det = torch.sum(det_valid.to(torch.int32))
        enough = bool(n_det >= cfg.frontend.min_detected)

        new_state = state
        if enough:
            disp_n = self._bm(left_f, self._image(right), det_xy, det_valid)
            identity = geo.pose_identity(device=self.device)
            p3, tri_valid = triangulate_from_disparities(
                disp_n, det_xy, det_valid, cfg.camera, identity)
            sigma_d = cfg.backend.stereo_prior_sigma_px
            if sigma_d > 0:
                fb = cfg.camera.focal * cfg.camera.baseline
                w_new = torch.where(tri_valid, _stereo_weight(fb, p3[:, 2], sigma_d), 0.0)
            else:
                w_new = torch.zeros(p3.shape[0], dtype=torch.float32, device=self.device)
            new_uv = _pad_to(det_xy, f_cap)
            no_uv = torch.zeros((f_cap, 2), dtype=torch.float32, device=self.device)
            no_lm = torch.zeros((f_cap,), dtype=torch.int32, device=self.device)
            no_valid = torch.zeros((f_cap,), dtype=torch.bool, device=self.device)
            window, ids, ids_valid = add_keyframe(
                state.window, cfg.backend, identity,
                no_uv, no_lm, no_valid, new_uv, _pad_to(p3, f_cap),
                _pad_to(tri_valid, f_cap), _pad_to(w_new, f_cap),
            )
            pyr = build_pyramid(left_f, cfg.frontend.lk_max_level)
            tracker = tracker_init(tuple(pyr), new_uv, ids, ids_valid)
            new_state = state._replace(
                tracker=tracker, window=window,
                initialized=self._scalar(True, torch.bool),
                pnp_pose=identity, cur_pose=identity,
            )
        new_state = new_state._replace(frame_idx=state.frame_idx + 1)
        zero = self._scalar(0, torch.int32)
        zf = self._scalar(0.0, torch.float32)
        out = StepOutput(
            pose_cw=new_state.cur_pose,
            pose_wc=geo.pose_inverse(new_state.cur_pose),
            is_keyframe=self._scalar(enough, torch.bool),
            pnp_ok=self._scalar(True, torch.bool),
            num_detected=n_det,
            num_tracked=zero,
            num_inliers=zero,
            num_new_landmarks=torch.sum(new_state.tracker.feat_valid.to(torch.int32)),
            av_parallax=zf,
            percent_lost=zf,
            ba_initial_cost=zf,
            ba_final_cost=zf,
            ba_iterations=zero,
            hinted=self._scalar(False, torch.bool),
            track_from=new_state.tracker.init_xy,
            track_to=new_state.tracker.feat_xy,
            track_valid=new_state.tracker.feat_valid,
        )
        return new_state, _with_summary(out)

    # ------------------------------------------------------------------
    def _pnp(self, lm_pos, feat_ids, feat_xy, feat_valid, prev_pose, frame_idx,
             hyp_idx=None) -> PnPResult:
        """PnP-RANSAC on the tracked features against the window's
        landmarks, seeded by the device frame index."""
        cfg = self.config
        with self._span("pnp"):
            world_pts = lm_pos[feat_ids.to(torch.int64)]
            return pnp_ransac(world_pts, feat_xy, feat_valid, cfg.camera, prev_pose, frame_idx,
                              cfg.frontend, hyp_idx=hyp_idx)

    def _skip_pnp(self, lm_pos, feat_ids, feat_xy, feat_valid, prev_pose, frame_idx,
                  hyp_idx=None) -> PnPResult:
        """The reference's ``_empty_pnp``: the warm start, no inlier, not ok."""
        return PnPResult(pose=prev_pose, inliers=torch.zeros_like(feat_valid),
                         num_inliers=self._scalar(0, torch.int64),
                         ok=self._scalar(False, torch.bool))

    def _keyframe_prep(self, left_f, right_f, pose, inliers, feat_xy, feat_ids, feat_valid,
                       window: WindowState, resp):
        """The keyframe work up to the solve: detect, dedup, sparse BM,
        triangulate, window update. Returns ``(window, det_xy, inlier_valid,
        new_ids, new_ids_valid, live)``, ``live`` the window's live-landmark
        count that chooses the solve."""
        with self._span("kf_prep"):
            cfg = self.config
            f_cap = cfg.backend.feature_capacity
            det_xy, det_valid = detect_features(left_f, cfg.frontend, resp=resp)
            # keyframe observations are the PnP inliers only
            inlier_valid = feat_valid & inliers
            new_valid = dedup_new_features(
                det_xy, det_valid, feat_xy, inlier_valid, cfg.frontend.min_distance)
            # sparse BM at the new detections and at the tracked inliers
            n_det = det_xy.shape[0]
            disp_cat = self._bm(
                left_f, right_f, torch.cat([det_xy, feat_xy], dim=0),
                torch.cat([new_valid, inlier_valid], dim=0),
                compact_slots=cfg.frontend.bm_compact_slots,
            )
            disp_new, disp_trk = disp_cat[:n_det], disp_cat[n_det:]
            p3_new, tri_valid = triangulate_from_disparities(
                disp_new, det_xy, new_valid, cfg.camera, pose)

            sigma_d = cfg.backend.stereo_prior_sigma_px
            fb = cfg.camera.focal * cfg.camera.baseline

            def prior_weight(p3, ok):
                z = geo.pose_apply(pose[None, :], p3)[:, 2]
                if sigma_d <= 0:
                    return torch.zeros_like(z)
                return torch.where(ok, _stereo_weight(fb, z, sigma_d), 0.0)

            w_new = prior_weight(p3_new, tri_valid)

            # tracked-landmark prior refresh, gated against the existing prior
            p3_trk, trk_ok = triangulate_from_disparities(
                disp_trk, feat_xy, inlier_valid, cfg.camera, pose)
            ids64 = feat_ids.to(torch.int64)
            prior_old = window.lm_prior[ids64]
            w_old = window.lm_prior_w[ids64]
            dist = _norm2(p3_trk - prior_old)
            z_trk = geo.pose_apply(pose[None, :], p3_trk)[:, 2]
            consistent = (w_old <= 0) | (dist < 0.25 * torch.clamp(z_trk, min=1.0))
            w_trk = torch.where(consistent, prior_weight(p3_trk, trk_ok), 0.0)
            if not cfg.backend.stereo_prior_refresh:
                w_trk = torch.zeros_like(w_trk)

            window, new_ids, new_ids_valid = add_keyframe(
                window, cfg.backend, pose,
                feat_xy, feat_ids, inlier_valid,
                _pad_to(det_xy, f_cap), _pad_to(p3_new, f_cap),
                _pad_to(tri_valid, f_cap), _pad_to(w_new, f_cap),
                tracked_prior_pos=p3_trk, tracked_prior_w=w_trk,
            )
            live = torch.sum(window.lm_valid, dtype=torch.int32)
            return window, det_xy, inlier_valid, new_ids, new_ids_valid, live

    def _skip_prep(self, left_f, right_f, pose, inliers, feat_xy, feat_ids, feat_valid,
                   window: WindowState, resp):
        """No keyframe: the window as it was, and nothing new."""
        fc = self.config.frontend
        no_det = torch.zeros((fc.max_detect, 2), dtype=torch.float32, device=feat_xy.device)
        return (window, no_det, torch.zeros_like(feat_valid), torch.zeros_like(feat_ids),
                torch.zeros_like(feat_valid), self._scalar(0, torch.int32))

    def _keyframe_solve(self, compact: bool, window: WindowState, det_xy, inlier_valid,
                        new_ids, new_ids_valid, feat_xy, feat_ids, flow_xy, flow_valid):
        """The solve and the tracker's slot re-init. Returns ``(window,
        opt_pose, slots, (ba_c0, ba_c1, ba_iters, n_new_landmarks))``."""
        cfg = self.config
        f_cap = cfg.backend.feature_capacity
        with self._span("ba"):
            window, ba_stats = bundle_adjust(window, cfg.camera, cfg.backend, compact=compact)
        opt_pose = newest_pose(window)

        # tracker re-init slots: inlier tracked + new features, valid first;
        # flow hints ride along under the same permutation
        cat_xy = torch.cat([feat_xy, _pad_to(det_xy, f_cap)], dim=0)
        cat_ids = torch.cat([feat_ids, new_ids], dim=0)
        cat_valid = torch.cat([inlier_valid, new_ids_valid], dim=0)
        cat_flow = torch.cat([flow_xy, torch.zeros_like(flow_xy)], dim=0)
        cat_flow_valid = torch.cat(
            [flow_valid & inlier_valid, torch.zeros_like(flow_valid)], dim=0)
        order = valid_first(cat_valid)[:f_cap]
        slots = (cat_xy[order], cat_ids[order], cat_valid[order],
                 cat_flow[order], cat_flow_valid[order])
        n_newlm = torch.sum(new_ids_valid, dtype=torch.int32)
        return window, opt_pose, slots, (
            ba_stats.initial_cost, ba_stats.final_cost, ba_stats.iterations, n_newlm)

    def _solve(self, compact: bool, window, det_xy, inlier_valid, new_ids, new_ids_valid,
               tracked: TrackerState, pnp_pose, cur_pose, res_pose):
        """The keyframe side of the reference's keyframe ``lax.cond``:
        ``((window, pnp_pose, cur_pose, slot_xy, slot_ids, slot_valid,
        slot_flow, slot_flow_valid), (ba_c0, ba_c1, ba_iters, n_newlm))``."""
        window, opt_pose, slots, stats = self._keyframe_solve(
            compact, window, det_xy, inlier_valid, new_ids, new_ids_valid,
            tracked.feat_xy, tracked.feat_ids, tracked.flow_xy, tracked.flow_valid)
        return (window, res_pose, opt_pose, *slots), stats

    def _skip_solve(self, window, det_xy, inlier_valid, new_ids, new_ids_valid,
                    tracked: TrackerState, pnp_pose, cur_pose, res_pose):
        """Its other side: the small state as it was, no BA."""
        zf = self._scalar(0.0, torch.float32)
        zero = self._scalar(0, torch.int32)
        return ((window, pnp_pose, cur_pose, tracked.feat_xy, tracked.feat_ids,
                 tracked.feat_valid, tracked.flow_xy, tracked.flow_valid),
                (zf, zf, zero, zero))

    # ------------------------------------------------------------------
    def _preprocess(self, lefts_f: torch.Tensor):
        """The state-independent per-frame work on ``[..., H, W]`` float32
        images: ``(pyramid levels, quality peak count, Shi-Tomasi response)``."""
        fc = self.config.frontend
        resp = min_eig_response(lefts_f, fc.detect_block_size)
        n_peaks = count_quality_peaks(
            lefts_f, fc.quality_level, fc.detect_block_size, resp=resp)
        return tuple(build_pyramid(lefts_f, fc.lk_max_level)), n_peaks, resp

    def _program(self, state, frame) -> graphs_module.Program:
        """The step program for this state and frame's signature, made at
        first use."""
        key = (graphs_module.signature(state), graphs_module.signature(frame))
        program = self.programs.get(key)
        if program is None:
            program = self.programs[key] = graphs_module.Program(
                f"step{len(self.programs)}", self._step_impl)
        return program

    def replay_chunk(self, state: VOState, lefts, rights
                     ) -> Tuple[VOState, torch.Tensor, torch.Tensor]:
        """Run ``K`` frames (``[K, H, W]`` host or device images) and return
        ``(state, poses [K, 7], summaries [K, 19])``, stacked on the device.

        As in the reference, the pyramid, the Shi-Tomasi response and the
        peak count do not depend on the carried state, so they run once over
        the whole chunk; each frame's step then takes its slice. On the card
        each frame is one replay of the step program, its slices copied into
        the program's inputs, and nothing is read back; the state handed out
        is a copy, so it outlives the engine's next call."""
        rec = self.recorder
        if rec is None:
            return self._replay_chunk(state, lefts, rights)
        return rec.call("replay_chunk", None, None, self._replay_chunk, state, lefts, rights)

    def _replay_chunk(self, state: VOState, lefts, rights):
        with self._span("preprocess", state.frame_idx):
            lefts_f = self._image(lefts)
            rights_f = self._image(rights)
            pyrs, n_peaks, resps = self._preprocess(lefts_f)
        k_frames = lefts_f.shape[0]
        summaries = torch.empty((k_frames, 7 + len(SUMMARY_KEYS)), dtype=torch.float32,
                                device=self.device)
        with record_function(CHUNK_RANGE):
            for k in range(k_frames):
                precomp = (tuple(level[k] for level in pyrs), n_peaks[k], resps[k])
                state, out = self.step(state, lefts_f[k], rights_f[k], precomp=precomp)
                summaries[k].copy_(out.summary)
        if self.graphs:
            leaves, spec = graphs_module.flatten(state)
            state = graphs_module.unflatten(spec, iter([t.clone() for t in leaves]))
        return state, summaries[:, :7], summaries

    def step(self, state: VOState, left, right,
             pnp_indices: Optional[torch.Tensor] = None,
             precomp=None) -> Tuple[VOState, StepOutput]:
        """One frame. ``pnp_indices [n_hyp - 1, k]`` replaces the seeded PnP
        hypothesis draw when given; ``precomp = (pyramid, n_peaks, resp)``
        supplies the frame's preprocessing when ``replay_chunk`` batched it."""
        rec = self.recorder
        if rec is None:
            return self._step(state, left, right, pnp_indices, precomp)
        return rec.call("step.enqueue", "step", state.frame_idx, self._step, state, left, right,
                        pnp_indices, precomp)

    def _step(self, state: VOState, left, right, pnp_indices, precomp):
        frame = (self._upload(left), self._upload(right),
                 None if precomp is None else (tuple(precomp[0]), precomp[1], precomp[2]),
                 pnp_indices)
        if not self.graphs:
            return self._step_impl(state, frame)
        return self._program(state, frame)(state, frame)

    def _step_impl(self, state: VOState, frame) -> Tuple[VOState, StepOutput]:
        """The step on device tensors, ``frame = (left, right, precomp,
        pnp_indices)``: ``[H, W]`` images (uint8 or float32), ``None`` or the
        frame's preprocessing, ``None`` or the injected draw."""
        left, right, precomp, pnp_indices = frame
        cfg = self.config
        fc = cfg.frontend
        left_f = left.to(torch.float32)
        right_f = right.to(torch.float32)

        # cheap every-frame bail: quality peak count
        pyr, n_peaks, resp = precomp if precomp is not None else self._preprocess(left_f)
        pyr = tuple(pyr)
        n_det = torch.clamp(n_peaks, max=fc.max_detect)
        has_det = n_peaks >= fc.min_detected

        # track unconditionally; a skipped frame discards the update below
        tr = state.tracker
        with self._span("track"):
            tracked, stats = track_step(tr, pyr, fc)
        accept = has_det & ((stats.av_parallax > fc.parallax_thresh)
                            | (stats.percent_lost >= fc.lost_thresh))

        # PnP runs only on accepted frames
        res = cond(accept, self._pnp, self._skip_pnp,
                   (state.window.lm_pos, tracked.feat_ids, tracked.feat_xy,
                    tracked.feat_valid, state.pnp_pose, state.frame_idx, pnp_indices))
        was_kf = accept & res.ok

        # the keyframe branch over the small state: its work up to the solve,
        # then the compacted or the full solve (the reference's choice on the
        # live-landmark count), each taken only on a keyframe
        prep = cond(was_kf, self._keyframe_prep, self._skip_prep,
                    (left_f, right_f, res.pose, res.inliers, tracked.feat_xy,
                     tracked.feat_ids, tracked.feat_valid, state.window, resp))
        solve_args = (*prep[:5], tracked, state.pnp_pose, state.cur_pose, res.pose)
        bc = cfg.backend
        if compaction_applies(bc, state.window.landmark_capacity):
            small = prep[5] <= bc.ba_compact_landmarks
            kf_out = cond(was_kf & small, functools.partial(self._solve, True),
                          self._skip_solve, solve_args)
            kf_out = cond(was_kf & ~small, functools.partial(self._solve, False),
                          lambda *_: kf_out, solve_args)
        else:
            kf_out = cond(was_kf, functools.partial(self._solve, False), self._skip_solve,
                          solve_args)
        (window, pnp_pose, cur_pose, slot_xy, slot_ids, slot_valid, slot_flow,
         slot_flow_valid), (ba_c0, ba_c1, ba_iters, n_newlm) = kf_out

        # reassemble the tracker state with elementwise selects
        def sel(kf_val, track_val, old_val):
            return torch.where(was_kf, kf_val, torch.where(has_det, track_val, old_val))

        new_tracker = TrackerState(
            pyramid=tuple(torch.where(has_det, new_l, old_l)
                          for new_l, old_l in zip(pyr, tr.pyramid)),
            feat_xy=sel(slot_xy, tracked.feat_xy, tr.feat_xy),
            feat_ids=sel(slot_ids, tracked.feat_ids, tr.feat_ids),
            feat_valid=sel(slot_valid, tracked.feat_valid, tr.feat_valid),
            init_xy=sel(slot_xy, tr.init_xy, tr.init_xy),
            init_count=sel(torch.sum(slot_valid, dtype=torch.int32), tr.init_count,
                           tr.init_count),
            # flow belongs to the frame pair, so a keyframe's re-init keeps it
            flow_xy=sel(slot_flow, tracked.flow_xy, tr.flow_xy),
            flow_valid=sel(slot_flow_valid, tracked.flow_valid, tr.flow_valid),
            pred_err=torch.where(has_det, tracked.pred_err, tr.pred_err),
        )
        new_state = VOState(
            tracker=new_tracker,
            window=window,
            pnp_pose=pnp_pose,
            cur_pose=cur_pose,
            frame_idx=state.frame_idx + 1,
            initialized=state.initialized,
        )
        zero = self._scalar(0, torch.int32)
        zf = self._scalar(0.0, torch.float32)
        out = StepOutput(
            pose_cw=cur_pose,
            pose_wc=geo.pose_inverse(cur_pose),
            is_keyframe=was_kf,
            pnp_ok=torch.where(accept, res.ok, self._scalar(True, torch.bool)),
            num_detected=n_det,
            num_tracked=torch.where(has_det, stats.num_tracked, zero),
            num_inliers=torch.where(accept, res.num_inliers, zero),
            num_new_landmarks=n_newlm,
            av_parallax=torch.where(has_det, stats.av_parallax, zf),
            percent_lost=torch.where(has_det, stats.percent_lost, zf),
            ba_initial_cost=ba_c0,
            ba_final_cost=ba_c1,
            ba_iterations=ba_iters,
            hinted=has_det & stats.hinted,
            track_from=tr.init_xy,
            track_to=torch.where(has_det, tracked.feat_xy, tr.feat_xy),
            track_valid=torch.where(was_kf, tracked.feat_valid & res.inliers,
                                    torch.where(has_det, tracked.feat_valid,
                                                tr.feat_valid)),
        )
        return new_state, _with_summary(out)
