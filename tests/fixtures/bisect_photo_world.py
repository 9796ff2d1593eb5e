#!/usr/bin/env python
"""Run one frame of the photo world through the JAX package and the PyTorch
port stage by stage, each port stage fed the reference's inputs, and print
where they part.

    JAX_PLATFORMS=cpu python tests/fixtures/bisect_photo_world.py --seed 11 --frames 1,2,3

The world is ``tests/test_long_sequence.py``'s (``kitti00``, 376x1241, the
photograph as texture; ``make_jax_reference.py``'s ``PHOTO``). For each
frame ``k`` the JAX engine steps frames ``0..k-1`` under ``jax.jit`` on the
CPU, then both packages run the stages of ``VOEngine.step`` and of its
keyframe work on the reference's state and its intermediate results: the
Shi-Tomasi response, the pyramid, ``track_step``, ``pnp_ransac`` (pose and
inlier set), ``detect_features``, ``dedup_new_features``, ``stereo_bm_at``,
both triangulations, the prior weights and their gate, ``add_keyframe`` and
``bundle_adjust`` on the reference's window. Each line gives the largest
absolute and relative difference and how many entries differ (integer and
bool outputs: how many differ). Then the reference's own bundle adjustment
of that window op by op (``jax.disable_jit``: no fused multiply-adds)
against its jitted one, and the condition number of its reduced camera
system: how far float32 rounding alone moves that solve.
"""

import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _report(name, got, want):
    g = got.detach().cpu().numpy() if hasattr(got, "detach") else np.asarray(got)
    w = np.asarray(want)
    if g.dtype == np.bool_ or np.issubdtype(g.dtype, np.integer):
        print(f"  {name:24s} {int((g != w).sum())} of {w.size} differ")
        return
    d = np.abs(g.astype(np.float64) - w)
    rel = float((d / np.maximum(np.abs(w), 1e-30)).max()) if d.size else 0.0
    print(f"  {name:24s} max abs {float(d.max()) if d.size else 0.0:.3g}, max rel {rel:.3g}, "
          f"{int((d > 0).sum())} of {d.size} differ")


def bisect_frame(seed: int, k: int) -> None:
    import jax
    import jax.numpy as jnp
    import torch

    from stereo_vo_tpu.backend import schur as JSC
    from stereo_vo_tpu.backend import window as JW
    from stereo_vo_tpu.core import geometry as JG
    from stereo_vo_tpu.core.config import load_config as jax_config
    from stereo_vo_tpu.data.synthetic import SyntheticStereoSequence, load_sample_photo
    from stereo_vo_tpu.engine import step as JS
    from stereo_vo_tpu.frontend import detect as JD
    from stereo_vo_tpu.frontend import pnp as JP
    from stereo_vo_tpu.frontend import track as JT
    from stereo_vo_tpu.frontend import triangulate as JTR
    from stereo_vo_tpu.ops import pyramid as JPY
    from stereo_vo_tpu.ops import shi_tomasi as JST
    from stereo_vo_tpu.ops import stereo_bm as JBM

    from stereo_vo_tpu_torch.backend import schur as TSC
    from stereo_vo_tpu_torch.backend import window as TW
    from stereo_vo_tpu_torch.core import geometry as TG
    from stereo_vo_tpu_torch.core.config import load_config as port_config
    from stereo_vo_tpu_torch.engine import step as TS
    from stereo_vo_tpu_torch.engine.convert import state_from_numpy
    from stereo_vo_tpu_torch.frontend import detect as TD
    from stereo_vo_tpu_torch.frontend import pnp as TP
    from stereo_vo_tpu_torch.frontend import track as TT
    from stereo_vo_tpu_torch.frontend import triangulate as TTR
    from stereo_vo_tpu_torch.ops import pyramid as TPY
    from stereo_vo_tpu_torch.ops import shi_tomasi as TST

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from make_jax_reference import PHOTO

    def T(x):
        return torch.from_numpy(np.array(np.asarray(x), copy=True))

    jcfg, tcfg = jax_config("kitti00"), port_config("kitti00")
    fc, tfc, cam = jcfg.frontend, tcfg.frontend, jcfg.camera
    shape = PHOTO["shape"]
    world = SyntheticStereoSequence(
        cam=cam, n_frames=161, seed=seed, texture=load_sample_photo(),
        **{key: v for key, v in PHOTO.items() if key != "texture"})
    jeng = JS.VOEngine(jcfg, shape)
    st = jeng.init_state()
    for i in range(k):
        left, right = world.render(i)
        step = jeng.step if bool(st.initialized) else jeng.bootstrap
        st, _ = step(st, jnp.asarray(left), jnp.asarray(right))
    tst = state_from_numpy([np.asarray(x) for x in jax.tree.leaves(st)], tcfg, shape,
                           device="cpu")
    left, right = world.render(k)
    lf, rf = jnp.asarray(left, jnp.float32), jnp.asarray(right, jnp.float32)
    tl, tr = T(left).float(), T(right).float()
    print(f"seed {seed}, frame {k}, from the reference's state after frame {k - 1}:")

    resp = jax.jit(lambda x: JST.min_eig_response(x, fc.detect_block_size))(lf)
    _report("response", TST.min_eig_response(tl, tfc.detect_block_size), resp)
    pyr = jax.jit(lambda x: JPY.build_pyramid(x, fc.lk_max_level))(lf)
    for i, (a, b) in enumerate(zip(TPY.build_pyramid(tl, tfc.lk_max_level), pyr)):
        _report(f"pyramid level {i}", a, b)
    tracked, stats = jax.jit(lambda s, p: JT.track_step(s, p, fc))(st.tracker, tuple(pyr))
    ttracked, tstats = TT.track_step(tst.tracker, tuple(T(x) for x in pyr), tfc)
    for name in ("feat_xy", "feat_valid", "flow_xy", "flow_valid"):
        _report(f"track {name}", getattr(ttracked, name), getattr(tracked, name))
    for name in stats._fields:
        _report(f"track {name}", getattr(tstats, name), getattr(stats, name))
    wp = st.window.lm_pos[tracked.feat_ids]
    res = jax.jit(lambda a, b, c, p, i: JP.pnp_ransac(a, b, c, cam, p, i, fc))(
        wp, tracked.feat_xy, tracked.feat_valid, st.pnp_pose, st.frame_idx.astype(jnp.uint32))
    tres = TP.pnp_ransac(T(wp), T(tracked.feat_xy), T(tracked.feat_valid), tcfg.camera,
                         T(st.pnp_pose), int(st.frame_idx), tfc)
    for name in res._fields:
        _report(f"pnp {name}", getattr(tres, name), getattr(res, name))
    if not bool(res.ok):
        print("  PnP failed: no keyframe work")
        return

    pose, inlier_valid = res.pose, tracked.feat_valid & res.inliers
    det_xy, det_valid = jax.jit(lambda x, r: JD.detect_features(x, fc, resp=r))(lf, resp)
    txy, tvalid = TD.detect_features(tl, tfc, resp=T(resp))
    _report("detect xy", txy, det_xy)
    _report("detect valid", tvalid, det_valid)
    new_valid = jax.jit(lambda a, b, c, d: JD.dedup_new_features(a, b, c, d, fc.min_distance))(
        det_xy, det_valid, tracked.feat_xy, inlier_valid)
    _report("dedup", TD.dedup_new_features(T(det_xy), T(det_valid), T(tracked.feat_xy),
                                           T(inlier_valid), tfc.min_distance), new_valid)
    n_det = det_xy.shape[0]
    cat_xy = jnp.concatenate([det_xy, tracked.feat_xy])
    cat_ok = jnp.concatenate([new_valid, inlier_valid])
    bm = jax.jit(lambda a, b, c, d: JBM.stereo_bm_at(
        a, b, c, d, num_disparities=fc.bm_num_disparities, block_size=fc.bm_block_size,
        prefilter_cap=fc.bm_prefilter_cap, texture_threshold=fc.bm_texture_threshold,
        uniqueness_ratio=fc.bm_uniqueness_ratio, compact_slots=fc.bm_compact_slots))
    disp = bm(lf, rf, cat_xy, cat_ok)
    teng = TS.VOEngine(tcfg, shape, device="cpu")
    _report("stereo_bm_at", teng._bm(tl, tr, T(cat_xy), T(cat_ok),
                                     compact_slots=tfc.bm_compact_slots), disp)
    tri = jax.jit(lambda a, b, c, p: JTR.triangulate_from_disparities(a, b, c, cam, p))
    p3n, triv = tri(disp[:n_det], det_xy, new_valid, pose)
    p3t, trk_ok = tri(disp[n_det:], tracked.feat_xy, inlier_valid, pose)
    for name, (a, b), args in (
            ("new", (p3n, triv), (disp[:n_det], det_xy, new_valid)),
            ("tracked", (p3t, trk_ok), (disp[n_det:], tracked.feat_xy, inlier_valid))):
        tp, tv = TTR.triangulate_from_disparities(*(T(x) for x in args), tcfg.camera, T(pose))
        _report(f"triangulate {name}", tp, a)
        _report(f"triangulate {name} ok", tv, b)

    sigma, fb = jcfg.backend.stereo_prior_sigma_px, cam.focal * cam.baseline

    def jax_priors(pose, window, p3n, triv, p3t, trk_ok, ids):
        def weight(p3, ok):
            z = JG.pose_apply(pose[None, :], p3)[:, 2]
            return jnp.where(ok, (fb / (jnp.maximum(z, 1.0) ** 2 * sigma)) ** 2, 0.0)
        dist = jnp.linalg.norm(p3t - window.lm_prior[ids], axis=-1)
        z_trk = JG.pose_apply(pose[None, :], p3t)[:, 2]
        ok = (window.lm_prior_w[ids] <= 0) | (dist < 0.25 * jnp.maximum(z_trk, 1.0))
        return weight(p3n, triv), jnp.where(ok, weight(p3t, trk_ok), 0.0), ok

    w_new, w_trk, gate = jax.jit(jax_priors)(pose, st.window, p3n, triv, p3t, trk_ok,
                                             tracked.feat_ids)
    tpose, ids = T(pose), T(tracked.feat_ids).long()

    def port_weight(p3, ok):
        z = TG.pose_apply(tpose[None, :], p3)[:, 2]
        return torch.where(ok, TS._stereo_weight(fb, z, sigma), 0.0)

    tdist = TS._norm2(T(p3t) - tst.window.lm_prior[ids])
    tz = TG.pose_apply(tpose[None, :], T(p3t))[:, 2]
    tgate = (tst.window.lm_prior_w[ids] <= 0) | (tdist < 0.25 * torch.clamp(tz, min=1.0))
    _report("prior weight new", port_weight(T(p3n), T(triv)), w_new)
    _report("prior gate", tgate, gate)
    _report("prior weight tracked", torch.where(tgate, port_weight(T(p3t), T(trk_ok)), 0.0),
            w_trk)

    f_cap = jcfg.backend.feature_capacity
    pad = JS._pad_to
    win, _, _ = jax.jit(lambda w, *a: JW.add_keyframe(
        w, jcfg.backend, a[0], a[1], a[2], a[3], pad(a[4], f_cap), pad(a[5], f_cap),
        pad(a[6], f_cap), pad(a[7], f_cap), tracked_prior_pos=a[8], tracked_prior_w=a[9]))(
        st.window, pose, tracked.feat_xy, tracked.feat_ids, inlier_valid, det_xy, p3n, triv,
        w_new, p3t, w_trk)
    twin, _, _ = TW.add_keyframe(
        tst.window, tcfg.backend, tpose, T(tracked.feat_xy), T(tracked.feat_ids),
        T(inlier_valid), TS._pad_to(T(det_xy), f_cap), TS._pad_to(T(p3n), f_cap),
        TS._pad_to(T(triv), f_cap), TS._pad_to(T(w_new), f_cap), tracked_prior_pos=T(p3t),
        tracked_prior_w=T(w_trk))
    for name in win._fields:
        if getattr(win, name) is not None:
            _report(f"window {name}", getattr(twin, name), getattr(win, name))

    jba = jax.jit(lambda w: JSC.bundle_adjust(w, cam, jcfg.backend))
    out, stats = jba(win)
    tout, tstats = TSC.bundle_adjust(TW.WindowState(*[None if x is None else T(x) for x in win]),
                                     tcfg.camera, tcfg.backend)
    for name in stats._fields:
        _report(f"BA {name}", getattr(tstats, name), getattr(stats, name))
    _report("BA poses", tout.poses, out.poses)
    _report("BA landmarks", tout.lm_pos, out.lm_pos)
    with jax.disable_jit():
        out2, stats2 = JSC.bundle_adjust(win, cam, jcfg.backend)
    print(f"  the reference's BA on its window: cost {float(stats.initial_cost):.7g} -> "
          f"{float(stats.final_cost):.7g} jitted, {float(stats2.initial_cost):.7g} -> "
          f"{float(stats2.final_cost):.7g} op by op; the port's {float(tstats.initial_cost):.7g}"
          f" -> {float(tstats.final_cost):.7g}")
    _report("reference op by op: final cost", stats2.final_cost, stats.final_cost)
    _report("reference op by op: poses", out2.poses, out.poses)
    _report("reference op by op: landmarks", out2.lm_pos, out.lm_pos)
    cond = JSC.reduced_camera_condition(JSC.window_to_landmark_major(win), cam, jcfg.backend,
                                        float(win.ba_lam))
    print(f"  condition number of the reduced camera system at the warm-start damping: "
          f"{float(cond):.4g}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--frames", default="1,2,3")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import jax

    jax.config.update("jax_platforms", "cpu")
    for k in (int(f) for f in args.frames.split(",")):
        bisect_frame(args.seed, k)
    return 0


if __name__ == "__main__":
    sys.exit(main())
