"""Typed configuration tree (counterpart of ``stereo_vo_tpu/core/config.py``).

The same frozen dataclasses with the same defaults. ``load_config`` reads the
camera YAMLs in this package's own ``configs/`` (byte-for-byte copies of the
JAX package's, which a test holds equal) and parses them with a small
parser of its own (``key: value`` lines, ``#`` comments, quoted strings and one
level of ``frontend:`` / ``backend:`` / ``runtime:`` sections) so the port
needs no YAML library. Anything else in a file raises ``ValueError``.

The comments on each constant, with the measurements behind the defaults,
live beside the reference's copy of the tree.
"""

from __future__ import annotations

import dataclasses

from vobench.reference.core.camera import CameraInfo



@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    """Detection / tracking / PnP / triangulation constants."""

    # Shi-Tomasi detection
    max_detect: int = 300
    quality_level: float = 0.1
    min_distance: float = 30.0
    min_detected: int = 4
    detect_block_size: int = 3
    nms_candidates: int = 1024

    # keyframe gate
    parallax_thresh: float = 20.0
    lost_thresh: float = 0.4

    # pyramidal LK
    lk_window: int = 21
    lk_max_level: int = 3
    lk_iters: int = 30
    lk_eps: float = 0.01
    lk_min_eig: float = 1e-2
    fb_thresh: float = 2.0
    max_parallax: float = 200.0

    # StereoBM
    bm_num_disparities: int = 48
    bm_block_size: int = 21
    bm_prefilter_cap: int = 31
    bm_texture_threshold: int = 10
    bm_uniqueness_ratio: int = 15
    # sparse-BM live-slot compaction: when at most this many query slots are
    # valid, match exactly this many (valid first); 0 disables
    bm_compact_slots: int = 320

    # PnP-RANSAC
    pnp_iterations: int = 100
    pnp_reproj_thresh: float = 8.0
    pnp_confidence: float = 0.99
    # backward-verification depth (finest levels); 0 = all levels
    lk_bwd_levels: int = 2
    # flow-hinted short-pyramid tracking gate (px) and its depth; 0 disables
    lk_hint_pred_err_px: float = 8.0
    lk_hint_levels: int = 2
    # LK live-slot compaction: when at most this many feature slots are
    # valid, track exactly this many (valid first); 0 disables
    lk_compact_slots: int = 160
    pnp_sample_size: int = 6
    pnp_refine_iters: int = 4
    pnp_hyp_polish_iters: int = 2
    pnp_warm_rounds: int = 2
    pnp_warm_iters: int = 2
    pnp_lo_rounds: int = 3


@dataclasses.dataclass(frozen=True)
class BackendConfig:
    """Sliding-window bundle-adjustment constants.

    ``reduced_solve_f64`` (the f64 island, YAML ``backend:
    reduced_solve_f64: true``): the port solves the reduced camera system in
    float64 whenever it is set. The reference honours it only when JAX runs
    with ``jax_enable_x64`` (``stereo_vo_tpu/backend/schur.py:611``) and
    otherwise solves in float32 with refinement, so with the flag set the two
    packages agree only under x64 (``tests/test_torch_precision.py``)."""

    window_size: int = 5
    max_features: int = 400
    feature_capacity: int = 448
    landmark_capacity: int = 2048
    max_lm_iters: int = 10
    lm_rel_tol: float = 1e-3
    # live-landmark compaction of the window solve; 0 disables
    ba_compact_landmarks: int = 512
    reduced_solve_refine: int = 1
    # solve the reduced camera system in float64, once, without refinement
    # (the f64 island; backend/schur.py)
    reduced_solve_f64: bool = False
    init_damping: float = 1e-4
    min_damping: float = 1e-6
    max_damping: float = 1e8
    lam_warm_start: bool = True
    min_depth: float = 1e-3
    stereo_prior_sigma_px: float = 1.0
    stereo_prior_refresh: bool = True
    huber_delta_px: float = 2.0


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """Host driver constants."""

    drop_time: float = 0.05
    loop_hz: float = 20.0
    replay_hz: float = 11.0
    image_queue_size: int = 5


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    camera: CameraInfo
    frontend: FrontendConfig = FrontendConfig()
    backend: BackendConfig = BackendConfig()
    runtime: RuntimeConfig = RuntimeConfig()
    left_topic: str = "/leftImage"
    right_topic: str = "/rightImage"
    frame_rate: float = 11.0
    name: str = "custom"
