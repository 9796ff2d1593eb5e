"""Structured per-frame metrics (counterpart of ``stereo_vo_tpu/engine/metrics.py``).

The reference's only runtime signals are rviz topics and a non-convergence
warning on stdout (``bundle_adjuster.cpp:142-144``); here every frame emits a
JSONL row: detection/tracking counts, parallax, PnP inliers, BA cost/iterations.
"""

from __future__ import annotations

import json
from typing import Optional


class MetricsLogger:
    def __init__(self, path: Optional[str]):
        self._fh = open(path, "w") if path else None

    def log(self, row: dict) -> None:
        if self._fh:
            self._fh.write(json.dumps(row) + "\n")

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None
