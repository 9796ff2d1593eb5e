"""Generic stereo stream API.

The host-side replacement for the reference's ROS transport layer
(``vo_node.cpp:28-29,100-125``): a stream yields timestamped stereo pairs; the
driver applies the same drop gate the reference's ``handle_images`` callback
applies (frames closer than ``drop_time`` apart are skipped,
``vo_node.cpp:63-74``) and a bounded queue decouples ingest from compute.

Copied from ``stereo_vo_tpu/data/stream.py``. Implementations:
``KittiSequence`` / ``kitti_replay`` (dataset replay, the ``kitti_node``
equivalent), ``SyntheticStereoSequence`` (test/bench worlds),
``LiveStereoStream`` (push-based live source), or any iterable of
``StereoFrame``.
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


class LiveStereoStream:
    """Push-based live stereo source — the servable equivalent of the
    reference's subscriber stack for the d435i/r200/multisense configs.

    Reproduces the reference's ingestion semantics end to end:

    - **approximate-time sync** of independently arriving left/right images
      (``message_filters::ApproximateTime``, ``vo_node.cpp:28-29,122``):
      a left and a right frame pair up when their stamps differ by at most
      ``sync_slop`` seconds; unmatched frames older than the newest frame on
      the other side by more than ``sync_slop`` are discarded;
    - **drop gate**: synced pairs closer than ``drop_time`` seconds to the
      previously queued pair are dropped (``handle_images``,
      ``vo_node.cpp:66-68``);
    - **bounded queue**: at most ``maxlen`` pairs buffer between ingest and
      compute; on overflow the oldest pair is discarded (a live camera must
      never block the producer). ``dropped`` counts both kinds of loss.

    Producers call ``push_left`` / ``push_right`` (or ``push`` for pre-synced
    pairs) from any thread; the VO driver iterates the stream. ``close()``
    ends iteration once the queue drains.
    """

    def __init__(self, sync_slop: float = 0.02, drop_time: float = 0.05,
                 maxlen: int = 5):
        import collections
        import threading

        self.sync_slop = float(sync_slop)
        self.drop_time = float(drop_time)
        self.maxlen = int(maxlen)
        self._left = collections.deque()    # (stamp, img)
        self._right = collections.deque()
        self._queue = collections.deque()
        self._cv = threading.Condition()
        self._closed = False
        self._index = 0
        self._last_stamp = None
        self.dropped = 0

    # ---- producer side ----------------------------------------------------
    def push_left(self, img: np.ndarray, stamp: float) -> None:
        with self._cv:
            self._left.append((float(stamp), img))
            self._try_match()

    def push_right(self, img: np.ndarray, stamp: float) -> None:
        with self._cv:
            self._right.append((float(stamp), img))
            self._try_match()

    def push(self, left: np.ndarray, right: np.ndarray, stamp: float) -> None:
        """Enqueue an already-synchronized pair (drop gate still applies)."""
        with self._cv:
            self._enqueue(left, right, float(stamp))

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    # ---- internal (lock held) ---------------------------------------------
    def _try_match(self) -> None:
        while self._left and self._right:
            tl, il = self._left[0]
            tr, ir = self._right[0]
            if abs(tl - tr) <= self.sync_slop:
                self._left.popleft()
                self._right.popleft()
                self._enqueue(il, ir, min(tl, tr))
            elif tl < tr - self.sync_slop:
                self._left.popleft()
                self.dropped += 1
            else:
                self._right.popleft()
                self.dropped += 1

    def _enqueue(self, left, right, stamp: float) -> None:
        if self._last_stamp is not None and stamp - self._last_stamp < self.drop_time:
            self.dropped += 1
            return
        self._last_stamp = stamp
        if len(self._queue) >= self.maxlen:
            self._queue.popleft()
            self.dropped += 1
        self._queue.append(
            StereoFrame(left=left, right=right, stamp=stamp, index=self._index)
        )
        self._index += 1
        self._cv.notify_all()

    # ---- consumer side ----------------------------------------------------
    def __iter__(self) -> Iterator[StereoFrame]:
        while True:
            with self._cv:
                while not self._queue and not self._closed:
                    self._cv.wait(timeout=0.1)
                if self._queue:
                    frame = self._queue.popleft()
                elif self._closed:
                    return
                else:
                    continue
            yield frame
