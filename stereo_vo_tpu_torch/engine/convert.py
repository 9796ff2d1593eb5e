"""The VO state as a flat list of numpy leaves, in the reference's order.

The JAX package's ``VOState`` flattens (``jax.tree.leaves``, the leaf order of
its ``engine/checkpoint.py`` npz files) into the list below; these functions
map such a list onto this package's ``VOState`` and back, so a state produced
by either package can start the other. With ``lk_max_level = L`` the pyramid
has ``L + 1`` leaves, so the list has ``L + 25`` entries (28 for the default
``L = 3``).

======  ==========================  ==========  =============================
index   field                       dtype       shape
======  ==========================  ==========  =============================
0..L    tracker.pyramid[0..L]       float32     [H_l, W_l]
L+1     tracker.feat_xy             float32     [F, 2]
L+2     tracker.feat_ids            int32       [F]
L+3     tracker.feat_valid          bool        [F]
L+4     tracker.init_xy             float32     [F, 2]
L+5     tracker.init_count          int32       []
L+6     tracker.flow_xy             float32     [F, 2]
L+7     tracker.flow_valid          bool        [F]
L+8     tracker.pred_err            float32     []
L+9     window.poses                float32     [W, 7]
L+10    window.pose_valid           bool        [W]
L+11    window.obs_uv               float32     [W, F, 2]
L+12    window.obs_lm               int32       [W, F]
L+13    window.obs_valid            bool        [W, F]
L+14    window.lm_pos               float32     [Lc, 3]
L+15    window.lm_refcount          int32       [Lc]
L+16    window.lm_valid             bool        [Lc]
L+17    window.lm_prior             float32     [Lc, 3]
L+18    window.lm_prior_w           float32     [Lc]
L+19    window.num_kf               int32       []
L+20    window.ba_lam               float32     []
L+21    pnp_pose                    float32     [7]
L+22    cur_pose                    float32     [7]
L+23    frame_idx                   int32       []
L+24    initialized                 bool        []
======  ==========================  ==========  =============================
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from stereo_vo_tpu_torch.backend.window import WindowState
from stereo_vo_tpu_torch.core.config import PipelineConfig
from stereo_vo_tpu_torch.engine.step import VOEngine, VOState
from stereo_vo_tpu_torch.frontend.track import TrackerState

_TORCH_DTYPES = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.bool_): torch.bool,
}


def _leaves_of(state: VOState) -> List[torch.Tensor]:
    tr, win = state.tracker, state.window
    return [
        *tr.pyramid,
        tr.feat_xy, tr.feat_ids, tr.feat_valid, tr.init_xy, tr.init_count,
        tr.flow_xy, tr.flow_valid, tr.pred_err,
        win.poses, win.pose_valid, win.obs_uv, win.obs_lm, win.obs_valid,
        win.lm_pos, win.lm_refcount, win.lm_valid, win.lm_prior, win.lm_prior_w,
        win.num_kf, win.ba_lam,
        state.pnp_pose, state.cur_pose, state.frame_idx, state.initialized,
    ]


def state_from_numpy(leaves: Sequence[np.ndarray], cfg: PipelineConfig, image_shape,
                     device="cpu") -> VOState:
    """Build a ``VOState`` on ``device`` from reference-ordered leaves; each
    leaf must have the shape and dtype of the engine's own state."""
    template = _leaves_of(VOEngine(cfg, image_shape, device="cpu").init_state())
    if len(leaves) != len(template):
        raise ValueError(f"expected {len(template)} leaves, got {len(leaves)}")
    ts = []
    for i, (leaf, tmpl) in enumerate(zip(leaves, template)):
        arr = np.asarray(leaf)
        if tuple(arr.shape) != tuple(tmpl.shape):
            raise ValueError(f"leaf {i}: shape {arr.shape} != {tuple(tmpl.shape)}")
        if _TORCH_DTYPES.get(arr.dtype) != tmpl.dtype:
            raise ValueError(f"leaf {i}: dtype {arr.dtype} does not map to {tmpl.dtype}")
        ts.append(torch.from_numpy(np.array(arr, copy=True)).to(device))
    n_pyr = cfg.frontend.lk_max_level + 1
    pyr, rest = tuple(ts[:n_pyr]), ts[n_pyr:]
    tracker = TrackerState(pyr, *rest[0:8])
    window = WindowState(*rest[8:20])
    return VOState(tracker, window, *rest[20:24])


def state_to_numpy(state: VOState) -> List[np.ndarray]:
    """The state's leaves as numpy arrays, in the reference's order."""
    return [leaf.detach().cpu().numpy() for leaf in _leaves_of(state)]
