"""Tracking layer: the median latency of the window's streamed steps whose
summary says not a keyframe (bootstraps left out), ms."""

import numpy as np


def read(window):
    lat = [s.seconds for s in window.steps if s.kind == "step" and not s.summary[7]]
    return float(np.median(lat) * 1000) if lat else None
