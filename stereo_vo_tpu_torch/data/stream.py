"""Generic stereo stream API.

The host-side replacement for the reference's ROS transport layer
(``vo_node.cpp:28-29,100-125``): a stream yields timestamped stereo pairs; the
driver applies the same drop gate the reference's ``handle_images`` callback
applies (frames closer than ``drop_time`` apart are skipped,
``vo_node.cpp:63-74``) and a bounded queue decouples ingest from compute.

Copied from ``stereo_vo_tpu/data/stream.py``. Streams here are
``SyntheticStereoSequence`` or any iterable of ``StereoFrame``; the KITTI
loader and the live push-based source are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Protocol

import numpy as np


@dataclasses.dataclass
class StereoFrame:
    """One synchronized stereo pair (the reference's ``StereoPair``,
    ``image_processor.hpp:9-17``)."""

    left: np.ndarray   # [H, W] grayscale uint8 or float32
    right: np.ndarray  # [H, W]
    stamp: float       # seconds
    index: int
    gt_pose: Optional[np.ndarray] = None  # [7] T_cw ground truth if known


class StereoStream(Protocol):
    def __iter__(self) -> Iterator[StereoFrame]: ...


def drop_gate(stream, drop_time: float):
    """Skip frames arriving closer than ``drop_time`` apart
    (``handle_images``, ``vo_node.cpp:66-68``)."""
    last = None
    for frame in stream:
        if last is not None and frame.stamp - last < drop_time:
            continue
        last = frame.stamp
        yield frame
