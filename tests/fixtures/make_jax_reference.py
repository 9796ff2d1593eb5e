#!/usr/bin/env python
"""Write the JAX package's reference results that the PyTorch port is held
to frame by frame (``tests/fixtures/jax_reference/``).

    JAX_PLATFORMS=cpu python tests/fixtures/make_jax_reference.py [--out DIR]

Runs ``stereo_vo_tpu`` on the CPU, in float32, and writes:

- ``kitti00_w20.npz``: ``run_vo`` streamed over ``chip_smoke.py`` phase 4's
  world (``kitti00`` intrinsics and defaults; 20 frames of 376x1241, seed 0,
  4000 points, 0.8 m and 0.003 rad per frame);
- ``kitti00_w129_c64.npz``: ``run_vo(chunk_size=64)`` over the same world at
  129 frames (``chip_smoke.py`` phase 5);
- ``kitti00_photo_s11_w161_c32.npz`` and ``kitti00_photo_s23_w161_c32.npz``:
  ``run_vo(chunk_size=32)`` over the photo-textured world of
  ``tests/test_long_sequence.py`` (161 frames of 376x1241, seeds 11 and 23,
  3000 points, 0.9 m and 0.004 rad per frame, the matplotlib sample
  photograph as the background texture; ``chip_smoke.py`` phase 5b and
  ``tests/test_torch_long_horizon.py``). Each also holds the reference's own
  float32 spread on that world: ``spread_summaries [SPREAD_TRIALS, 161,
  19]``, the same run with every input of every bundle adjustment nudged
  by at most one ulp (``lm_pos`` and ``obs_uv``, each element up, down or
  not, drawn from the trial's seed), the size of the rounding differences
  between two float32 implementations;
- ``d435i_w12.npz``, ``kitti03_w12.npz``, ``kitti08_w12.npz`` and
  ``multisense_w12.npz``: ``run_vo`` streamed over 12 frames of the same
  billboard world at the ``d435i`` (480x640), ``kitti03`` (375x1242),
  ``kitti08`` (370x1226) and ``multisense`` (801x801) geometries, each with
  its own intrinsics (``tests/test_torch_trajectory.py``; ``chip_smoke.py``
  phase 4c). The ``d435i`` and ``multisense`` ones also hold the
  reference's own spread, as the photo world's do: with 5 and 7 cm
  baselines their bundle adjustments are ill-conditioned, and their
  one-ulp-nudged reruns part from them from frames 2-3 on;
- ``pnp_draws.npz``: ``N_DRAW_MASKS`` seeded valid masks over 448 slots, their
  seeds, and the minimal samples ``stereo_vo_tpu/frontend/pnp.py::pnp_ransac``
  draws for each (``[M, 99, 6]``: ``pnp_iterations - 1`` hypotheses of
  ``pnp_sample_size`` slots).

Each trajectory file holds the published poses ``[N, 7]``, the per-frame
summary vectors ``[N, 19]`` (the pose, then ``SUMMARY_KEYS``), the world's
parameters, the texture (``"none"`` or ``"grace_hopper"``, with the texture's
shape and the sum of its pixels), the chunk size, the seconds the run took and
``jax.__version__``. The depth range of a world depends on its frame count, so
a shorter run of the photo world renders all 161 frames and stops early
(``run_vo(max_frames=...)``); it never builds a shorter world.
The JAX package needs no device; the port's machines need no JAX.
Deterministic: re-running reproduces the files within float32 rounding
(``tests/test_torch_trajectory.py::test_reference_fixture_regenerates``).
"""

import argparse
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "jax_reference")

CONFIG = "kitti00"               # a run's config, unless its world names another
BILLBOARD = dict(shape=(376, 1241), n_points=4000, seed=0, speed=0.8, yaw_rate=0.003,
                 texture="none")
PHOTO = dict(shape=(376, 1241), n_points=3000, speed=0.9, yaw_rate=0.004,
             texture="grace_hopper")
RUNS = {                      # file stem: (world, frames, chunk size)
    "kitti00_w20": (BILLBOARD, 20, 0),
    "d435i_w12": (dict(BILLBOARD, shape=(480, 640), config="d435i"), 12, 0),
    "kitti03_w12": (dict(BILLBOARD, shape=(375, 1242), config="kitti03"), 12, 0),
    "kitti08_w12": (dict(BILLBOARD, shape=(370, 1226), config="kitti08"), 12, 0),
    "multisense_w12": (dict(BILLBOARD, shape=(801, 801), config="multisense"), 12, 0),
    "kitti00_w129_c64": (BILLBOARD, 129, 64),
    "kitti00_photo_s11_w161_c32": (dict(PHOTO, seed=11), 161, 32),
    "kitti00_photo_s23_w161_c32": (dict(PHOTO, seed=23), 161, 32),
}
# the runs that also store nudged reruns (the reference's own spread), and
# how many
SPREAD_RUNS = ("d435i_w12", "multisense_w12", "kitti00_photo_s11_w161_c32",
               "kitti00_photo_s23_w161_c32")
SPREAD_TRIALS = 3
N_DRAW_MASKS = 64
DRAW_SLOTS = 448


def _jax_cpu():
    sys.path.insert(0, ROOT)
    import jax

    jax.config.update("jax_platforms", "cpu")
    return jax


def _nudged_bundle_adjust(trial: int):
    """``bundle_adjust`` with its window's ``lm_pos`` and ``obs_uv`` moved by
    at most one ulp per element, in directions drawn from ``trial`` and the
    window (so each call gets its own)."""
    import jax
    import jax.numpy as jnp

    from stereo_vo_tpu.backend.schur import bundle_adjust

    def nudge(x, key):
        step = jax.random.randint(key, x.shape, -1, 2)
        return jnp.where(step > 0, jnp.nextafter(x, jnp.inf),
                         jnp.where(step < 0, jnp.nextafter(x, -jnp.inf), x))

    def nudged(window, cam, cfg, *args, **kwargs):
        key = jax.random.fold_in(jax.random.PRNGKey(trial),
                                 window.num_kf * 7919 + jnp.sum(window.obs_lm))
        k1, k2 = jax.random.split(key)
        window = window._replace(lm_pos=nudge(window.lm_pos, k1),
                                 obs_uv=nudge(window.obs_uv, k2))
        return bundle_adjust(window, cam, cfg, *args, **kwargs)

    return nudged


def _summaries(run, SUMMARY_KEYS):
    rows = np.array([[float(s[k]) for k in SUMMARY_KEYS] for s in run.frame_stats],
                    np.float32)
    return np.concatenate([np.asarray(run.poses, np.float32), rows], axis=1)


def run_reference(world_args: dict, n_frames: int, chunk_size: int, spread: bool) -> dict:
    """The JAX package's ``run_vo`` over ``world_args``' world of
    ``n_frames``; with ``spread`` also ``SPREAD_TRIALS`` nudged reruns."""
    jax = _jax_cpu()
    import stereo_vo_tpu.engine.step as engine_step
    from stereo_vo_tpu.core.config import load_config
    from stereo_vo_tpu.data.synthetic import SyntheticStereoSequence, load_sample_photo
    from stereo_vo_tpu.engine import run_vo
    from stereo_vo_tpu.engine.step import SUMMARY_KEYS

    config = world_args.get("config", CONFIG)
    cfg = load_config(config)
    texture = None
    if world_args["texture"] == "grace_hopper":
        texture = load_sample_photo()
        assert texture is not None, "matplotlib's sample photograph is missing"
    kw = {k: v for k, v in world_args.items() if k not in ("texture", "config")}
    world = SyntheticStereoSequence(cam=cfg.camera, n_frames=n_frames, texture=texture, **kw)
    frames = list(world)
    t0 = time.perf_counter()
    run = run_vo(iter(frames), cfg, chunk_size=chunk_size)
    seconds = time.perf_counter() - t0
    summaries = _summaries(run, SUMMARY_KEYS)
    out = {
        "poses": summaries[:, :7],
        "summaries": summaries,
        "summary_keys": np.array(SUMMARY_KEYS),
        "n_frames": np.int32(n_frames),
        "chunk_size": np.int32(chunk_size),
        **{k: np.asarray(v) for k, v in world_args.items()},
        "config": np.array(config),
        "texture_shape": np.asarray(texture.shape if texture is not None else (0, 0), np.int32),
        "texture_sum": np.float64(texture.astype(np.float64).sum() if texture is not None else 0.0),
        "seconds": np.float64(seconds),
        "jax_version": np.array(jax.__version__),
    }
    if spread:
        reruns, original = [], engine_step.bundle_adjust
        for trial in range(1, SPREAD_TRIALS + 1):
            engine_step.bundle_adjust = _nudged_bundle_adjust(trial)
            try:
                reruns.append(_summaries(run_vo(iter(frames), cfg, chunk_size=chunk_size),
                                         SUMMARY_KEYS))
            finally:
                engine_step.bundle_adjust = original
        out["spread_summaries"] = np.stack(reruns)
        out["spread_trials"] = np.arange(1, SPREAD_TRIALS + 1, dtype=np.int32)
    return out


def draw_reference() -> dict:
    """Valid masks with shares from none to all, uint32 seeds (frame indices
    and random words, both ends of the range included), and the reference's
    draw for each."""
    _jax_cpu()
    import jax
    import jax.numpy as jnp

    from stereo_vo_tpu.core.config import FrontendConfig

    fc = FrontendConfig()
    n_masks, f_cap = N_DRAW_MASKS, DRAW_SLOTS
    rng = np.random.default_rng(2026)
    shares = np.concatenate([[0.0, 1.0, 3 / f_cap, 5 / f_cap],
                             rng.uniform(0.0, 1.0, n_masks - 4)])
    valid = rng.random((n_masks, f_cap)) < shares[:, None]
    seeds = np.concatenate([np.arange(n_masks // 2), [2**31, 2**32 - 1],
                            rng.integers(0, 2**32, n_masks // 2 - 2)]).astype(np.uint32)

    @jax.jit
    def draw(v, seed):
        # the calls of stereo_vo_tpu/frontend/pnp.py::pnp_ransac
        n_valid = jnp.sum(v.astype(jnp.int32))
        probs = v.astype(jnp.float32) / jnp.maximum(n_valid, 1).astype(jnp.float32)
        keys = jax.random.split(jax.random.PRNGKey(seed), fc.pnp_iterations - 1)
        return jax.vmap(lambda hk: jax.random.choice(
            hk, f_cap, shape=(fc.pnp_sample_size,), replace=False, p=probs))(keys)

    idx = np.stack([np.asarray(draw(v, s)) for v, s in zip(valid, seeds)])
    return {"valid": valid, "seeds": seeds, "indices": idx.astype(np.int16),
            "jax_version": np.array(jax.__version__)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--only", nargs="*", default=None,
                    help="write only these files (stems, or pnp_draws)")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    if not args.only or "pnp_draws" in args.only:
        np.savez_compressed(os.path.join(args.out, "pnp_draws.npz"), **draw_reference())
    for stem, (world_args, n_frames, chunk) in RUNS.items():
        if args.only and stem not in args.only:
            continue
        ref = run_reference(world_args, n_frames, chunk, stem in SPREAD_RUNS)
        np.savez_compressed(os.path.join(args.out, stem + ".npz"), **ref)
        spread = ref.get("spread_summaries")
        print(f"{stem}: {n_frames} frames in {float(ref['seconds']):.1f} s, "
              f"{int(ref['summaries'][:, 7].sum())} keyframes"
              + ("" if spread is None else
                 f", nudged reruns {[int(k) for k in spread[:, :, 7].sum(axis=1)]} keyframes"),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
