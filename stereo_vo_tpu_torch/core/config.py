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
import os
import re
from typing import Optional

from stereo_vo_tpu_torch.core.camera import CameraInfo

CONFIG_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs")


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


def _apply_overrides(cfg, overrides: dict):
    """Apply a flat/nested dict of overrides onto a frozen dataclass tree."""
    if not overrides:
        return cfg
    updates = {}
    for key, val in overrides.items():
        cur = getattr(cfg, key)
        if dataclasses.is_dataclass(cur) and isinstance(val, dict):
            updates[key] = _apply_overrides(cur, val)
        else:
            updates[key] = val
    return dataclasses.replace(cfg, **updates)


_SECTIONS = ("frontend", "backend", "runtime")
_LINE = re.compile(r"^(?P<indent>[ ]*)(?P<key>[A-Za-z_][A-Za-z0-9_]*):(?P<rest>.*)$")
_INT = re.compile(r"^[-+]?[0-9]+$")
_FLOAT = re.compile(r"^[-+]?(\.[0-9]+|[0-9]+(\.[0-9]*)?)([eE][-+]?[0-9]+)?$")


def _strip_comment(text: str) -> str:
    """Drop a trailing ``#`` comment that is not inside quotes."""
    quote = None
    for i, ch in enumerate(text):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "\"'":
            quote = ch
        elif ch == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i]
    return text


def _scalar(text: str, where: str):
    """A YAML scalar as the config files write them."""
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "\"'":
        return text[1:-1]
    if text in ("true", "True", "false", "False"):
        return text in ("true", "True")
    if _INT.match(text):
        return int(text)
    if _FLOAT.match(text):
        return float(text)
    if re.match(r"^[A-Za-z_/][A-Za-z0-9_/.\-]*$", text):
        return text
    raise ValueError(f"{where}: cannot parse value {text!r}")


def parse_config_yaml(text: str, source: str = "<config>") -> dict:
    """Parse the subset of YAML the camera configs use; raise on anything else."""
    raw: dict = {}
    section = None
    section_indent = None
    for lineno, line in enumerate(text.splitlines(), 1):
        where = f"{source}:{lineno}"
        if "\t" in line:
            raise ValueError(f"{where}: tabs are not supported")
        body = _strip_comment(line).rstrip()
        if not body.strip():
            continue
        m = _LINE.match(body)
        if m is None:
            raise ValueError(f"{where}: expected 'key: value', got {line!r}")
        indent = len(m.group("indent"))
        key = m.group("key")
        rest = m.group("rest").strip()
        if indent == 0:
            section = None
            if not rest:
                if key not in _SECTIONS:
                    raise ValueError(f"{where}: unknown section {key!r}")
                if key in raw:
                    raise ValueError(f"{where}: duplicate section {key!r}")
                raw[key] = {}
                section, section_indent = key, None
                continue
            if key in raw:
                raise ValueError(f"{where}: duplicate key {key!r}")
            raw[key] = _scalar(rest, where)
            continue
        if section is None:
            raise ValueError(f"{where}: indented line outside a section")
        if section_indent is None:
            section_indent = indent
        if indent != section_indent or not rest:
            raise ValueError(f"{where}: only one level of nesting is supported")
        if key in raw[section]:
            raise ValueError(f"{where}: duplicate key {key!r}")
        raw[section][key] = _scalar(rest, where)
    return raw


def load_config(name_or_path: str, overrides: Optional[dict] = None) -> PipelineConfig:
    """Load a camera YAML by bundled name (e.g. ``"kitti00"``) or by path."""
    path = name_or_path
    if not os.path.exists(path):
        path = os.path.join(CONFIG_DIR, name_or_path + ".yaml")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"no config named {name_or_path!r}; bundled: {sorted(available_configs())}"
        )
    with open(path) as f:
        raw = parse_config_yaml(f.read(), path)

    cam = CameraInfo(
        focal=float(raw["focal_length"]),
        cx=float(raw["cx"]),
        cy=float(raw["cy"]),
        baseline=float(raw["baseline"]),
        k1=float(raw.get("k1", 0.0)),
        k2=float(raw.get("k2", 0.0)),
        p1=float(raw.get("p1", 0.0)),
        p2=float(raw.get("p2", 0.0)),
    )
    cfg = PipelineConfig(
        camera=cam,
        left_topic=str(raw.get("left_topic", "/leftImage")),
        right_topic=str(raw.get("right_topic", "/rightImage")),
        frame_rate=float(raw.get("frame_rate", 11.0)),
        name=os.path.splitext(os.path.basename(path))[0],
    )
    for section in _SECTIONS:
        if section in raw:
            cfg = _apply_overrides(cfg, {section: raw[section]})
    if overrides:
        cfg = _apply_overrides(cfg, overrides)
    return cfg


def available_configs():
    return [os.path.splitext(f)[0] for f in os.listdir(CONFIG_DIR) if f.endswith(".yaml")]
