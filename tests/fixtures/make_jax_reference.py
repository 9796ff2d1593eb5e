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
- ``pnp_draws.npz``: ``N_DRAW_MASKS`` seeded valid masks over 448 slots, their
  seeds, and the minimal samples ``stereo_vo_tpu/frontend/pnp.py::pnp_ransac``
  draws for each (``[M, 99, 6]``: ``pnp_iterations - 1`` hypotheses of
  ``pnp_sample_size`` slots).

Each trajectory file holds the published poses ``[N, 7]``, the per-frame
summary vectors ``[N, 19]`` (the pose, then ``SUMMARY_KEYS``), the world's
parameters, the chunk size, the seconds the run took and ``jax.__version__``.
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

CONFIG = "kitti00"
WORLD = dict(shape=(376, 1241), n_points=4000, seed=0, speed=0.8, yaw_rate=0.003)
RUNS = {                      # file stem: (frames, chunk size)
    "kitti00_w20": (20, 0),
    "kitti00_w129_c64": (129, 64),
}
N_DRAW_MASKS = 64
DRAW_SLOTS = 448


def _jax_cpu():
    sys.path.insert(0, ROOT)
    import jax

    jax.config.update("jax_platforms", "cpu")
    return jax


def run_reference(n_frames: int, chunk_size: int) -> dict:
    """The JAX package's ``run_vo`` over the world of ``n_frames``."""
    jax = _jax_cpu()
    from stereo_vo_tpu.core.config import load_config
    from stereo_vo_tpu.data.synthetic import SyntheticStereoSequence
    from stereo_vo_tpu.engine import run_vo
    from stereo_vo_tpu.engine.step import SUMMARY_KEYS

    cfg = load_config(CONFIG)
    world = SyntheticStereoSequence(cam=cfg.camera, n_frames=n_frames, **WORLD)
    frames = list(world)
    t0 = time.perf_counter()
    run = run_vo(iter(frames), cfg, chunk_size=chunk_size)
    seconds = time.perf_counter() - t0
    rows = np.array([[float(s[k]) for k in SUMMARY_KEYS] for s in run.frame_stats],
                    np.float32)
    poses = np.asarray(run.poses, np.float32)
    return {
        "poses": poses,
        "summaries": np.concatenate([poses, rows], axis=1),
        "summary_keys": np.array(SUMMARY_KEYS),
        "config": np.array(CONFIG),
        "n_frames": np.int32(n_frames),
        "chunk_size": np.int32(chunk_size),
        **{k: np.asarray(v) for k, v in WORLD.items()},
        "seconds": np.float64(seconds),
        "jax_version": np.array(jax.__version__),
    }


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
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    np.savez_compressed(os.path.join(args.out, "pnp_draws.npz"), **draw_reference())
    for stem, (n_frames, chunk) in RUNS.items():
        ref = run_reference(n_frames, chunk)
        np.savez_compressed(os.path.join(args.out, stem + ".npz"), **ref)
        print(f"{stem}: {n_frames} frames in {float(ref['seconds']):.1f} s, "
              f"{int(ref['summaries'][:, 7].sum())} keyframes", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
