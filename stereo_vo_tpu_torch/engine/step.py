"""The per-frame VO step (counterpart of ``stereo_vo_tpu/engine/step.py``).

``VOEngine.bootstrap`` seeds the tracker and window from the first frame with
enough detections; ``VOEngine.step`` runs one frame: the every-frame
detection-count bail, fused forward/backward LK tracking, the
parallax/lost keyframe gate, PnP on accepted frames, and on keyframes
detection, dedup, sparse StereoBM, triangulation, the window update and the
Schur-LM solve. Each of the reference's ``lax.cond`` branches is a Python
``if`` on a 0-d tensor here, so every branch costs one host sync and only the
taken branch runs.

The PnP hypotheses are drawn from a generator seeded with the frame index;
``step(..., pnp_indices=...)`` injects them instead.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from stereo_vo_tpu_torch.backend.schur import bundle_adjust
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
from stereo_vo_tpu_torch.frontend.detect import dedup_new_features, detect_features
from stereo_vo_tpu_torch.frontend.pnp import PnPResult, pnp_ransac
from stereo_vo_tpu_torch.frontend.track import NO_FLOW, TrackerState, track_step, tracker_init
from stereo_vo_tpu_torch.frontend.triangulate import triangulate_from_disparities
from stereo_vo_tpu_torch.ops.pyramid import build_pyramid
from stereo_vo_tpu_torch.ops.shi_tomasi import count_quality_peaks, min_eig_response
from stereo_vo_tpu_torch.ops.stereo_bm import stereo_bm_at


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

    @property
    def summary(self) -> torch.Tensor:
        """The pose and every per-frame scalar (``SUMMARY_KEYS`` order) in one
        float32 vector, so the host fetches one buffer per frame."""
        scalars = torch.stack(
            [getattr(self, k).to(torch.float32) for k in SUMMARY_KEYS]
        )
        return torch.cat([self.pose_cw.to(torch.float32), scalars])


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
    return torch.sqrt(torch.sum(v * v, dim=-1))


def _stereo_weight(fb: float, z: torch.Tensor, sigma_d: float) -> torch.Tensor:
    """Stereo depth-noise prior weight ``(f b / (max(z, 1)^2 sigma_d))^2``."""
    return (torch.full_like(z, fb) / (torch.clamp(z, min=1.0) ** 2 * sigma_d)) ** 2


class VOEngine:
    """Bootstrap/step functions closed over one config, image shape and device.

    TF32 is switched off for both matmuls and cuDNN: the port matches the
    reference in float32."""

    def __init__(self, config: PipelineConfig, image_shape: Tuple[int, int],
                 device="cpu"):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.config = config
        self.image_shape = tuple(image_shape)
        self.device = torch.device(device)

    def _image(self, img) -> torch.Tensor:
        """A host or device image as float32 on the engine's device (uint8
        images cross to the device before the conversion)."""
        if not isinstance(img, torch.Tensor):
            img = torch.from_numpy(np.ascontiguousarray(img))
        return img.to(self.device).to(torch.float32)

    def _scalar(self, value, dtype) -> torch.Tensor:
        return torch.as_tensor(value, dtype=dtype, device=self.device)

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
        return new_state, out

    # ------------------------------------------------------------------
    def _keyframe_work(self, left_f, right_f, pose, inliers, tracked: TrackerState,
                       window: WindowState, resp):
        """Keyframe branch: detect, dedup, sparse BM, triangulate, window
        update, BA, tracker re-init slots. Returns ``(window, opt_pose, slots,
        (ba_c0, ba_c1, ba_iters, n_new_landmarks))``."""
        cfg = self.config
        f_cap = cfg.backend.feature_capacity
        feat_xy, feat_ids = tracked.feat_xy, tracked.feat_ids
        det_xy, det_valid = detect_features(left_f, cfg.frontend, resp=resp)
        # keyframe observations are the PnP inliers only
        inlier_valid = tracked.feat_valid & inliers
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
        window, ba_stats = bundle_adjust(window, cfg.camera, cfg.backend)
        opt_pose = newest_pose(window)

        # tracker re-init slots: inlier tracked + new features, valid first;
        # flow hints ride along under the same permutation
        cat_xy = torch.cat([feat_xy, _pad_to(det_xy, f_cap)], dim=0)
        cat_ids = torch.cat([feat_ids, new_ids], dim=0)
        cat_valid = torch.cat([inlier_valid, new_ids_valid], dim=0)
        cat_flow = torch.cat([tracked.flow_xy, torch.zeros_like(tracked.flow_xy)], dim=0)
        cat_flow_valid = torch.cat(
            [tracked.flow_valid & inlier_valid, torch.zeros_like(tracked.flow_valid)], dim=0)
        order = valid_first(cat_valid)[:f_cap]
        slots = (cat_xy[order], cat_ids[order], cat_valid[order],
                 cat_flow[order], cat_flow_valid[order])
        n_newlm = torch.sum(new_ids_valid.to(torch.int32))
        return window, opt_pose, slots, (
            ba_stats.initial_cost, ba_stats.final_cost, ba_stats.iterations, n_newlm)

    # ------------------------------------------------------------------
    def step(self, state: VOState, left, right,
             pnp_indices: Optional[torch.Tensor] = None) -> Tuple[VOState, StepOutput]:
        """One frame. ``pnp_indices [n_hyp - 1, k]`` replaces the seeded PnP
        hypothesis draw when given."""
        cfg = self.config
        left_f = self._image(left)
        right_f = self._image(right)

        # cheap every-frame bail: quality peak count
        resp = min_eig_response(left_f, cfg.frontend.detect_block_size)
        n_peaks = count_quality_peaks(
            left_f, cfg.frontend.quality_level, cfg.frontend.detect_block_size, resp=resp)
        pyr = tuple(build_pyramid(left_f, cfg.frontend.lk_max_level))
        n_det = torch.clamp(n_peaks, max=cfg.frontend.max_detect)
        has_det = bool(n_peaks >= cfg.frontend.min_detected)

        # track unconditionally; a skipped frame discards the update below
        tracked, stats = track_step(state.tracker, pyr, cfg.frontend)

        accept = has_det and bool(
            (stats.av_parallax > cfg.frontend.parallax_thresh)
            | (stats.percent_lost >= cfg.frontend.lost_thresh)
        )
        if accept:
            world_pts = get_world_points(state.window, tracked.feat_ids)
            res = pnp_ransac(
                world_pts, tracked.feat_xy, tracked.feat_valid, cfg.camera,
                state.pnp_pose, int(state.frame_idx), cfg.frontend, hyp_idx=pnp_indices,
            )
        else:
            res = PnPResult(
                pose=state.pnp_pose,
                inliers=torch.zeros_like(tracked.feat_valid),
                num_inliers=self._scalar(0, torch.int32),
                ok=self._scalar(False, torch.bool),
            )
        was_kf = accept and bool(res.ok)

        tr = state.tracker
        zf = self._scalar(0.0, torch.float32)
        zero = self._scalar(0, torch.int32)
        if was_kf:
            window, opt_pose, slots, (ba_c0, ba_c1, ba_iters, n_newlm) = self._keyframe_work(
                left_f, right_f, res.pose, res.inliers, tracked, state.window, resp)
            slot_xy, slot_ids, slot_valid, slot_flow, slot_flow_valid = slots
            pnp_pose, cur_pose = res.pose, opt_pose
            new_tracker = TrackerState(
                pyramid=pyr, feat_xy=slot_xy, feat_ids=slot_ids, feat_valid=slot_valid,
                init_xy=slot_xy, init_count=torch.sum(slot_valid, dtype=torch.int32),
                flow_xy=slot_flow, flow_valid=slot_flow_valid, pred_err=tracked.pred_err,
            )
        else:
            window, pnp_pose, cur_pose = state.window, state.pnp_pose, state.cur_pose
            ba_c0, ba_c1, ba_iters, n_newlm = zf, zf, zero, zero
            new_tracker = tracked if has_det else tr

        new_state = VOState(
            tracker=new_tracker,
            window=window,
            pnp_pose=pnp_pose,
            cur_pose=cur_pose,
            frame_idx=state.frame_idx + 1,
            initialized=state.initialized,
        )
        if was_kf:
            track_valid = tracked.feat_valid & res.inliers
        else:
            track_valid = tracked.feat_valid if has_det else tr.feat_valid
        out = StepOutput(
            pose_cw=cur_pose,
            pose_wc=geo.pose_inverse(cur_pose),
            is_keyframe=self._scalar(was_kf, torch.bool),
            pnp_ok=res.ok if accept else self._scalar(True, torch.bool),
            num_detected=n_det,
            num_tracked=stats.num_tracked if has_det else zero,
            num_inliers=res.num_inliers if accept else zero,
            num_new_landmarks=n_newlm,
            av_parallax=stats.av_parallax if has_det else zf,
            percent_lost=stats.percent_lost if has_det else zf,
            ba_initial_cost=ba_c0,
            ba_final_cost=ba_c1,
            ba_iterations=ba_iters,
            hinted=stats.hinted if has_det else self._scalar(False, torch.bool),
            track_from=tr.init_xy,
            track_to=tracked.feat_xy if has_det else tr.feat_xy,
            track_valid=track_valid,
        )
        return new_state, out
