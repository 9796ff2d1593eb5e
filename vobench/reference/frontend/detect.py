"""Detection wrapper + spatial dedup against tracked features (counterpart of
``stereo_vo_tpu/frontend/detect.py``)."""

from __future__ import annotations

from typing import Tuple

import torch

from vobench.reference.core.config import FrontendConfig
from vobench.reference.ops.shi_tomasi import detect_corners


def detect_features(
    img: torch.Tensor, cfg: FrontendConfig, resp: torch.Tensor = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Detect up to ``cfg.max_detect`` corners; returns ``(xy [D, 2], valid [D])``.
    ``resp`` is an optional precomputed Shi-Tomasi response."""
    xy, _, valid = detect_corners(
        img,
        max_corners=cfg.max_detect,
        quality_level=cfg.quality_level,
        min_distance=cfg.min_distance,
        block_size=cfg.detect_block_size,
        resp=resp,
    )
    return xy, valid


def dedup_new_features(
    new_xy: torch.Tensor,
    new_valid: torch.Tensor,
    tracked_xy: torch.Tensor,
    tracked_valid: torch.Tensor,
    min_distance: float,
) -> torch.Tensor:
    """Drop new detections within ``min_distance`` of any valid tracked
    feature; returns the updated validity mask for ``new_xy``."""
    d2 = torch.sum((new_xy[:, None, :] - tracked_xy[None, :, :]) ** 2, dim=-1)
    close = (d2 < min_distance * min_distance) & tracked_valid[None, :]
    return new_valid & ~torch.any(close, dim=1)
