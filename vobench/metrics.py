"""The end-to-end metrics' arithmetic, over everything a window did.

- ``replay_fps``: every frame the window finished over the window's seconds
  (uploads, bootstraps, chunks, fetches and the host between them inside).
- ``step_p50_ms`` / ``step_p95_ms``: the median and the 95th percentile of
  every streamed call's latency in the window, bootstraps included, from
  handing the host pair over to the pose on the host (numpy's linear
  interpolation between order statistics).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from vobench.drive import Window


def end_to_end(win: Window) -> Dict[str, float]:
    out = {}
    if win.seconds > 0 and win.frames:
        out["replay_fps"] = win.frames / win.seconds
    lat = np.array([s.seconds for s in win.steps], np.float64)
    if len(lat):
        out["step_p50_ms"] = float(np.percentile(lat, 50) * 1000)
        out["step_p95_ms"] = float(np.percentile(lat, 95) * 1000)
    return out
