"""Offline visualization (counterpart of ``stereo_vo_tpu/eval/viz.py``).

Replaces the reference's rviz displays (``config/rviz_config.rviz``,
``launch/vo_rviz.launch``): the feature-track debug image (the
``/feature_tracking`` topic, ``feature_tracker.cpp:74-83``) and a VO-vs-GT
trajectory plot (the GT path + VO path overlay).

Host-only. cv2 draws and writes the track image where it is installed; without
it the image is drawn with numpy and saved as ``<path>.npy``. matplotlib is
imported only when a plot is asked for.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def draw_tracks(
    image: np.ndarray,
    from_xy: np.ndarray,
    to_xy: np.ndarray,
    valid: np.ndarray,
) -> np.ndarray:
    """Green arrows from each feature's keyframe position to its current one
    (``FeatureTracker::draw_track``). Returns an RGB uint8 image."""
    img = np.asarray(image)
    if img.ndim == 2:
        rgb = np.stack([img, img, img], axis=-1).astype(np.uint8)
    else:
        rgb = img.astype(np.uint8).copy()
    try:
        import cv2
    except ImportError:
        cv2 = None
    tracks = [(f, t) for f, t, v in zip(np.asarray(from_xy), np.asarray(to_xy),
                                        np.asarray(valid)) if v]
    if cv2 is not None:
        for f, t in tracks:
            cv2.arrowedLine(
                rgb,
                (int(round(f[0])), int(round(f[1]))),
                (int(round(t[0])), int(round(t[1]))),
                (0, 255, 0),
                2,
            )
        return rgb
    h, w = rgb.shape[:2]
    for f, t in tracks:
        n = max(int(np.hypot(*(t - f))) * 2, 2)
        xs = np.clip(np.linspace(f[0], t[0], n).astype(int), 0, w - 1)
        ys = np.clip(np.linspace(f[1], t[1], n).astype(int), 0, h - 1)
        rgb[ys, xs] = (0, 255, 0)
    return rgb


def write_image(path: str, img: np.ndarray) -> str:
    """Write an RGB image with cv2, or as ``<path>.npy`` without it; returns
    the path written."""
    try:
        import cv2
    except ImportError:
        np.save(path + ".npy", img)
        return path + ".npy"
    cv2.imwrite(path, img[..., ::-1])  # RGB -> BGR
    return path


def require_matplotlib():
    """The ``matplotlib.pyplot`` module on the Agg backend, or a clear error."""
    try:
        import matplotlib
    except ImportError as e:
        raise RuntimeError(
            "trajectory plots need matplotlib, which is not installed") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_trajectory(
    est_positions: np.ndarray,
    gt_positions: Optional[np.ndarray] = None,
    out_path: Optional[str] = None,
    title: str = "VO trajectory",
):
    """Top-down (x-z) trajectory plot, VO vs ground truth."""
    plt = require_matplotlib()
    fig, ax = plt.subplots(figsize=(7, 7))
    ax.plot(est_positions[:, 0], est_positions[:, 2], "-", label="VO", lw=1.5)
    if gt_positions is not None:
        ax.plot(gt_positions[:, 0], gt_positions[:, 2], "--", label="ground truth", lw=1.2)
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.set_title(title)
    ax.axis("equal")
    ax.legend()
    if out_path:
        fig.savefig(out_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
        return out_path
    return fig
