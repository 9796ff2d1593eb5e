"""KITTI odometry dataset loader and replay (counterpart of
``stereo_vo_tpu/data/kitti.py``).

Replaces the reference's ``kitti_node`` (``kitti_node.cpp:18-119``): loads
grayscale ``image_0``/``image_1`` PNG pairs with zero-padded six-digit ids
(``kitti_node.cpp:25-27,56-68``), parses 3x4 row-major ground-truth pose rows
(``kitti_node.cpp:47-51``), and replays pairs with a shared timestamp at a
nominal rate (11 Hz, ``kitti_node.cpp:46``). No IPC: the loader feeds the
driver directly, with optional background prefetch so disk IO overlaps device
compute.

Expected layout (standard KITTI odometry, or the flat layout the reference
hard-codes at ``kitti_node.cpp:16``):

    root/sequences/00/image_0/000000.png   (or root/00/image_0/...)
    root/sequences/00/image_1/000000.png
    root/poses/00.txt                      (or root/00.txt / root/00/00.txt)
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Iterator, Optional

import numpy as np
import torch

from stereo_vo_tpu_torch.core import geometry as geo
from stereo_vo_tpu_torch.data import native_loader
from stereo_vo_tpu_torch.data.stream import StereoFrame


def _imread_gray(path: str) -> np.ndarray:
    """Grayscale uint8 image: the native decoder (bit-exact against OpenCV on
    grayscale, see ``native/svo_io.cpp``), else cv2, else PIL."""
    if native_loader.native_available():
        return native_loader.read_png_gray(path)
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
        if img is None:
            raise FileNotFoundError(path)
        return img
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError(
            "no PNG decoder: the native library could not be built "
            f"({native_loader.build_error()}) and neither cv2 nor PIL is installed"
        ) from e
    with Image.open(path) as im:
        return np.asarray(im.convert("L"))


def parse_kitti_poses(path: str) -> np.ndarray:
    """Parse a KITTI ground-truth pose file into ``[N, 7]`` T_cw pose vectors.

    Each row is a 3x4 row-major camera-to-world matrix [R_wc | t_wc]
    (``kitti_node.cpp:47-51,79-95``); we invert to the framework's T_cw
    convention: ``q_cw = conj(q_wc)``, ``t_cw = -R_cw t_wc``.
    """
    rows = np.loadtxt(path).reshape(-1, 3, 4)
    r_wc = torch.as_tensor(rows[:, :, :3], dtype=torch.float32)
    t_wc = torch.as_tensor(rows[:, :, 3], dtype=torch.float32)
    q_cw = geo.quat_conj(geo.rotmat_to_quat(r_wc))
    t_cw = -geo.rot_apply(q_cw, t_wc)
    return geo.make_pose(q_cw, t_cw).numpy()


class KittiSequence:
    """Indexable loader for one KITTI odometry sequence."""

    def __init__(self, root: str, sequence: str, rate_hz: float = 11.0):
        self.sequence = sequence
        self.rate_hz = rate_hz

        candidates = [
            os.path.join(root, "sequences", sequence),
            os.path.join(root, sequence),
        ]
        seq_dir = next((c for c in candidates if os.path.isdir(c)), None)
        if seq_dir is None:
            raise FileNotFoundError(f"KITTI sequence {sequence!r} not under {root!r}")
        self.left_dir = os.path.join(seq_dir, "image_0")
        self.right_dir = os.path.join(seq_dir, "image_1")
        self._ids = sorted(
            os.path.splitext(f)[0]
            for f in os.listdir(self.left_dir)
            if f.endswith(".png")
        )

        pose_candidates = [
            os.path.join(root, "poses", sequence + ".txt"),
            os.path.join(root, sequence + ".txt"),
            os.path.join(seq_dir, sequence + ".txt"),
        ]
        pose_path = next((c for c in pose_candidates if os.path.isfile(c)), None)
        self.gt_poses: Optional[np.ndarray] = (
            parse_kitti_poses(pose_path) if pose_path else None
        )

    def __len__(self) -> int:
        return len(self._ids)

    def __getitem__(self, i: int) -> StereoFrame:
        fid = self._ids[i]
        left = _imread_gray(os.path.join(self.left_dir, fid + ".png"))
        right = _imread_gray(os.path.join(self.right_dir, fid + ".png"))
        gt = self.gt_poses[i] if self.gt_poses is not None and i < len(self.gt_poses) else None
        return StereoFrame(
            left=left, right=right, stamp=i / self.rate_hz, index=i, gt_pose=gt
        )

    def __iter__(self) -> Iterator[StereoFrame]:
        for i in range(len(self)):
            yield self[i]


def kitti_replay(
    root: str,
    sequence: str,
    rate_hz: float = 11.0,
    prefetch: int = 4,
    max_frames: Optional[int] = None,
) -> Iterator[StereoFrame]:
    """Replay a sequence with a background prefetch thread, so disk IO and
    decoding overlap the device's work. A decode error in the thread is
    raised in the consumer."""
    seq = KittiSequence(root, sequence, rate_hz)
    n = len(seq) if max_frames is None else min(len(seq), max_frames)
    if prefetch <= 0:
        for i in range(n):
            yield seq[i]
        return

    q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    stop = object()

    def worker():
        try:
            for i in range(n):
                q.put(seq[i])
        except Exception as e:  # handed to the consumer, which re-raises it
            q.put(e)
        q.put(stop)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is stop:
            break
        if isinstance(item, Exception):
            raise item
        yield item
