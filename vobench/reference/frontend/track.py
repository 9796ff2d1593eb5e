"""Feature-tracker state machine (counterpart of ``stereo_vo_tpu/frontend/track.py``).

Fixed-capacity masked arrays; each call tracks from the last image to the
current one with fused forward/backward LK (or, with ``flow_back=False``,
forward-only LK) and applies the reference's gates:
the 2 px round trip, ``max_parallax``, parallax against the keyframe position
averaged over the *kept* features, and ``percent_lost = 1 - kept / init_count``.

Flow-hinted tracking: when the previous step's p90 prediction error over kept
features is below ``cfg.lk_hint_pred_err_px``, LK starts each feature at
``pts + predicted flow`` and runs only the ``cfg.lk_hint_levels`` finest
levels. A step that keeps nothing, or loses more than 30% of the features
that carried a flow estimate, resets the gate to the full pyramid.

Both choices are the reference's ``lax.cond``s, taken by
``engine/graphs.py::cond``: on the device inside the card's step graph, by
one host read of the predicate elsewhere. The hinted choice is one; on the
CPU the live-slot compaction is the other: when at most
``cfg.lk_compact_slots`` slots are valid, the plain level pass runs on
exactly that many slots (valid first, stable order) and the results are
written back by plain indexing. Per-feature results do not depend on batch
position, so the compacted and the full-width results are bitwise equal; on
the card LK runs at full width with no compaction, since an inactive slot
exits the level-pass kernel at once.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from vobench.reference.core.config import FrontendConfig
from vobench.reference.core.consts import const
from vobench.reference.core.f32 import sqrt_f32
from vobench.reference.ops.lk import lk_track_fwdbwd, lk_track_pyramid

# sentinel for "no flow estimate yet": always takes the full pyramid
NO_FLOW = 1e9


class TrackerState(NamedTuple):
    pyramid: Tuple[torch.Tensor, ...]  # last image pyramid (level 0..L)
    feat_xy: torch.Tensor              # [F, 2] current positions
    feat_ids: torch.Tensor             # [F] int32 landmark ids
    feat_valid: torch.Tensor           # [F] bool
    init_xy: torch.Tensor              # [F, 2] positions at keyframe init
    init_count: torch.Tensor           # [] int32 feature count at init
    flow_xy: torch.Tensor              # [F, 2] previous step's flow
    flow_valid: torch.Tensor           # [F] bool
    pred_err: torch.Tensor             # [] float32 hint gate statistic


class TrackStats(NamedTuple):
    av_parallax: torch.Tensor   # [] float
    percent_lost: torch.Tensor  # [] float
    num_tracked: torch.Tensor   # [] int32
    hinted: torch.Tensor        # [] bool: this step ran the hinted short pyramid


def _norm2(v: torch.Tensor) -> torch.Tensor:
    return sqrt_f32(torch.sum(v * v, dim=-1))


def _flow_hint(feat_xy, flow_xy, flow_valid):
    """Per-feature predicted flow: its own previous flow, else the nearest
    tracked neighbour's; zero when no feature has one."""
    d2 = torch.sum((feat_xy[:, None, :] - feat_xy[None, :, :]) ** 2, dim=-1)
    d2 = torch.where(flow_valid[None, :], d2, 1e12)
    nn = torch.argmin(d2, dim=1)
    hint = torch.where(flow_valid[:, None], flow_xy, flow_xy[nn])
    return torch.where(torch.any(flow_valid), hint, torch.zeros_like(hint))


def tracker_init(
    pyramid: Tuple[torch.Tensor, ...],
    xy: torch.Tensor,
    ids: torch.Tensor,
    valid: torch.Tensor,
    flow_xy: Optional[torch.Tensor] = None,
    flow_valid: Optional[torch.Tensor] = None,
    pred_err: Optional[torch.Tensor] = None,
) -> TrackerState:
    """Snapshot the feature set on a new keyframe (``FeatureTracker::init``)."""
    if flow_xy is None:
        flow_xy = torch.zeros_like(xy)
    if flow_valid is None:
        flow_valid = torch.zeros(xy.shape[0], dtype=torch.bool, device=xy.device)
    if pred_err is None:
        pred_err = const(NO_FLOW, torch.float32, xy.device)
    return TrackerState(
        pyramid=tuple(pyramid),
        feat_xy=xy,
        feat_ids=ids,
        feat_valid=valid,
        init_xy=xy,
        init_count=torch.sum(valid, dtype=torch.int32),
        flow_xy=flow_xy,
        flow_valid=flow_valid,
        pred_err=pred_err,
    )


def track_step(
    state: TrackerState,
    new_pyramid: Tuple[torch.Tensor, ...],
    cfg: FrontendConfig,
    flow_back: bool = True,
) -> Tuple[TrackerState, TrackStats]:
    """One tracking update (``FeatureTracker::track_features``).

    ``flow_back=False`` tracks forward only (``lk_track_pyramid`` over the
    full pyramid at full width): no round-trip gate, no hint, no compaction,
    and the next step's hint gate reads ``NO_FLOW``."""
    # engine/__init__ imports this module, so the engine's graphs come late
    from vobench.reference.engine import graphs

    prev_pyr = list(state.pyramid)
    new_pyr = list(new_pyramid)
    kwargs = dict(
        window=cfg.lk_window, max_iters=cfg.lk_iters, eps=cfg.lk_eps,
        min_eig_threshold=cfg.lk_min_eig,
    )
    hint_thresh = cfg.lk_hint_pred_err_px
    hint_levels = cfg.lk_hint_levels
    use_hint_path = flow_back and hint_thresh > 0 and 0 < hint_levels < len(prev_pyr)
    dev = state.feat_xy.device
    hint = None
    hinted = const(False, torch.bool, dev)
    if use_hint_path:
        hint = _flow_hint(state.feat_xy, state.flow_xy, state.flow_valid)
        hinted = state.pred_err < hint_thresh

    def full(pts, val, hint_vec):
        return lk_track_fwdbwd(prev_pyr, new_pyr, pts, val, bwd_levels=cfg.lk_bwd_levels,
                               **kwargs)

    def short(pts, val, hint_vec):
        return lk_track_fwdbwd(
            prev_pyr[:hint_levels], new_pyr[:hint_levels], pts, val,
            init_flow=hint_vec, bwd_from_original=True,
            bwd_levels=cfg.lk_bwd_levels, **kwargs,
        )

    def run_lk(pts, val, hint_vec):
        if not use_hint_path:
            return full(pts, val, hint_vec)
        return graphs.cond(hinted, short, full, (pts, val, hint_vec))

    f = state.feat_xy.shape[0]
    k = cfg.lk_compact_slots
    if not flow_back:
        fwd_xy, ok = lk_track_pyramid(prev_pyr, new_pyr, state.feat_xy, state.feat_valid,
                                      **kwargs)
    else:
        if 0 < k < f and dev.type == "cpu":
            # the plain level pass iterates every slot it is given; the
            # card's kernel lets an inactive slot exit at once
            def compacted():
                idx = torch.sort((~state.feat_valid).to(torch.uint8), stable=True).indices[:k]
                f_xy, f_ok, b_xy, b_ok = run_lk(
                    state.feat_xy[idx], state.feat_valid[idx],
                    None if hint is None else hint[idx],
                )
                fwd = state.feat_xy.clone()
                fwd[idx] = f_xy
                bwd = state.feat_xy.clone()
                bwd[idx] = b_xy
                f_okf = torch.zeros_like(state.feat_valid)
                f_okf[idx] = f_ok
                b_okf = torch.zeros_like(state.feat_valid)
                b_okf[idx] = b_ok
                return fwd, f_okf, bwd, b_okf

            def full_width():
                return run_lk(state.feat_xy, state.feat_valid, hint)

            live = torch.sum(state.feat_valid, dtype=torch.int32)
            fwd_xy, fwd_ok, bwd_xy, bwd_ok = graphs.cond(live <= k, compacted, full_width)
        else:
            fwd_xy, fwd_ok, bwd_xy, bwd_ok = run_lk(state.feat_xy, state.feat_valid, hint)
        ok = fwd_ok & bwd_ok & (_norm2(state.feat_xy - bwd_xy) < cfg.fb_thresh)

    parallax = _norm2(fwd_xy - state.init_xy)
    ok = ok & (parallax <= cfg.max_parallax)

    kept = torch.sum(ok.to(torch.int32))
    av_parallax = torch.sum(torch.where(ok, parallax, 0.0)) / torch.clamp(kept, min=1)
    percent_lost = 1.0 - kept.to(torch.float32) / torch.clamp(
        state.init_count, min=1
    ).to(torch.float32)

    # prediction-error gate for the next step, measured against the hint in
    # both branches (p90 over kept features)
    step_flow = fwd_xy - state.feat_xy
    if use_hint_path:
        perr = _norm2(step_flow - hint)
        desc = torch.sort(torch.where(ok, perr, -float("inf")), descending=True).values
        k90 = (kept.to(torch.float32) * 0.1).to(torch.int64)
        pred_err_now = torch.index_select(
            desc, 0, torch.clamp(k90, max=perr.shape[0] - 1).reshape(1))[0]
        experienced = state.feat_valid & state.flow_valid
        n_prev = torch.sum(experienced.to(torch.int32))
        kept_exp = torch.sum((ok & experienced).to(torch.int32))
        step_loss = 1.0 - kept_exp.to(torch.float32) / torch.clamp(n_prev, min=1)
        pred_err = torch.where(
            (kept == 0) | (step_loss > 0.30),
            const(NO_FLOW, torch.float32, dev),
            pred_err_now,
        )
    else:
        pred_err = const(NO_FLOW, torch.float32, dev)

    new_state = state._replace(
        pyramid=tuple(new_pyramid),
        feat_xy=torch.where(ok[:, None], fwd_xy, state.feat_xy),
        feat_valid=ok,
        flow_xy=torch.where(ok[:, None], step_flow, 0.0),
        flow_valid=ok,
        pred_err=pred_err,
    )
    return new_state, TrackStats(
        av_parallax=av_parallax, percent_lost=percent_lost, num_tracked=kept, hinted=hinted,
    )
