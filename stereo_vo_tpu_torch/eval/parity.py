"""Frame-by-frame comparison of a run with a reference run of the same world.

The reference is the JAX package's ``run_vo`` on the CPU, stored by
``tests/fixtures/make_jax_reference.py`` as per-frame summary vectors
``[N, 19]``: the published pose ``[q, t]``, then ``SUMMARY_KEYS``.
``frame_differences`` reads two such arrays; ``run_summaries`` builds one
from a ``VORun``.
"""

from __future__ import annotations

import numpy as np

from stereo_vo_tpu_torch.engine.step import SUMMARY_KEYS

# the integer fields a port run must reproduce frame by frame
INT_KEYS = ("is_keyframe", "pnp_ok", "num_detected", "num_tracked", "num_inliers",
            "num_new_landmarks", "ba_iterations", "hinted")
BA_KEYS = ("ba_initial_cost", "ba_final_cost")


def run_summaries(run) -> np.ndarray:
    """``[N, 19]`` float32 summary vectors of a ``VORun``, in the layout of
    ``StepOutput.summary``."""
    rows = np.array([[float(s[k]) for k in SUMMARY_KEYS] for s in run.frame_stats],
                    np.float32).reshape(len(run.frame_stats), len(SUMMARY_KEYS))
    return np.concatenate([np.asarray(run.poses, np.float32), rows], axis=1)


def frame_differences(got: np.ndarray, want: np.ndarray) -> dict:
    """Per-frame differences of summaries ``got`` from ``want`` (both
    ``[N, 19]``): ``dq`` and ``dt``, the max |difference| of the quaternion
    and of the translation; ``got - want`` of each of ``INT_KEYS``; and the
    relative difference of each of ``BA_KEYS`` (against ``max(|want|,
    1e-12)``)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape:
        raise ValueError(f"summaries {got.shape} and {want.shape} differ in shape")
    col = {k: 7 + i for i, k in enumerate(SUMMARY_KEYS)}
    out = {"dq": np.abs(got[:, :4] - want[:, :4]).max(axis=1),
           "dt": np.abs(got[:, 4:7] - want[:, 4:7]).max(axis=1)}
    for k in INT_KEYS:
        out[k] = (got[:, col[k]] - want[:, col[k]]).astype(np.int64)
    for k in BA_KEYS:
        ref = np.maximum(np.abs(want[:, col[k]]), 1e-12)
        out[k] = np.abs(got[:, col[k]] - want[:, col[k]]) / ref
    return out
