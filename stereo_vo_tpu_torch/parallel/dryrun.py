"""Multi-rank dry run of the landmark-sharded solver (counterpart of the JAX
package's ``__graft_entry__.dryrun_multichip``).

    python -m stereo_vo_tpu_torch.parallel.dryrun 4                 # 4 ranks on cuda
    python -m stereo_vo_tpu_torch.parallel.dryrun 4 --device cpu

Spawns N local ranks in one gloo world (gloo, because NCCL refuses two ranks
on one card; on the CPU there is no other choice) and runs:

1. a tiny data-parallel batch over a ``dp x lm`` mesh (dp = 2 when N is even
   and at least 4), checked window by window against single-device solves;
2. the reference-sized (5 poses x 2048 landmarks) and big (32 x 16384)
   problems, sharded over 1, 2, 4 and 8 ranks (as many as N allows), each
   held against the single-device ``lm_loop`` (poses within 2e-4, landmarks
   within 2e-3, the JAX dry run's bounds), with LM iterations per second.

It prints the bytes all-reduced per damping attempt and per accepted build.
With N ranks on one card the timings measure correctness of the collective
path, not an interconnect. ``solve_on_cpu_ranks`` runs one sharded solve on
N local CPU ranks and returns numpy results.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time

import numpy as np
import torch

from stereo_vo_tpu_torch.backend.schur import LandmarkMajorProblem, lm_loop
from stereo_vo_tpu_torch.core.camera import CameraInfo
from stereo_vo_tpu_torch.core.config import BackendConfig
from stereo_vo_tpu_torch.parallel.distributed import _map_leaves, spawn_ranks
from stereo_vo_tpu_torch.parallel.mesh import make_mesh
from stereo_vo_tpu_torch.parallel.sharded_ba import (
    dp_sharded_bundle_adjust,
    sharded_bundle_adjust,
    sharded_lm_solve,
)

# (tag, window size, landmark capacity) of the JAX dry run
SHAPES = (("ref_5x2048", 5, 2048), ("big_32x16384", 32, 16384))
ITERS = 4                 # LM iterations per timed solve, as in the JAX dry run
POSE_TOL = 2e-4
LM_TOL = 2e-3


def _device(kind: str, rank: int) -> torch.device:
    if kind == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        return dev
    return torch.device(kind)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _to_device(tree, dev):
    return _map_leaves(lambda x: None if x is None else torch.as_tensor(np.asarray(x)).to(dev),
                       tree)


def _to_numpy(tree):
    return _map_leaves(lambda x: x.detach().cpu().numpy(), tree)


def make_lm_problem(w: int, lcap: int, cam: CameraInfo, noise: float = 0.5, seed: int = 0
                    ) -> LandmarkMajorProblem:
    """Well-posed synthetic landmark-major problem (numpy), the same numbers
    as the JAX dry run's: landmarks ahead of a camera moving along x, every
    landmark seen by every pose with pixel noise, perturbed poses and
    landmarks."""
    rng = np.random.default_rng(seed)
    lm = np.concatenate(
        [rng.uniform(-20, 20, (lcap, 2)), rng.uniform(5, 60, (lcap, 1))], axis=1
    ).astype(np.float32)
    poses = np.tile(np.array([1, 0, 0, 0, 0, 0, 0], np.float32), (w, 1))
    poses[:, 4] = -0.5 * np.arange(w)
    obs = np.zeros((lcap, w, 2), np.float32)
    for wi in range(w):
        p = lm + np.array([poses[wi, 4], 0, 0])
        obs[:, wi, 0] = cam.focal * p[:, 0] / p[:, 2] + cam.cx
        obs[:, wi, 1] = cam.focal * p[:, 1] / p[:, 2] + cam.cy
    obs += rng.normal(size=obs.shape).astype(np.float32) * noise
    poses_n = poses + np.concatenate(
        [np.zeros((w, 4)), rng.normal(size=(w, 3)) * 0.02], axis=1
    ).astype(np.float32)
    return LandmarkMajorProblem(
        poses=poses_n,
        pose_valid=np.ones(w, bool),
        lm_pos=lm + rng.normal(size=lm.shape).astype(np.float32) * 0.05,
        lm_valid=np.ones(lcap, bool),
        obs_uv=obs,
        obs_valid=np.ones((lcap, w), bool),
        lm_prior=lm,
        lm_prior_w=np.zeros(lcap, np.float32),
    )


def _tiny_batch(b: int, lm: int):
    """The JAX dry run's tiny batch: ``b`` windows of 3 poses and ``8 * lm``
    landmarks with exact projections and perturbed landmarks."""
    cam = CameraInfo(focal=100.0, cx=32.0, cy=24.0, baseline=0.2)
    cfg = BackendConfig(window_size=3, max_features=8, feature_capacity=8,
                        landmark_capacity=8 * lm, max_lm_iters=3)
    w, l = cfg.window_size, cfg.landmark_capacity
    rng = np.random.default_rng(0)
    lm_pos = np.concatenate(
        [rng.uniform(-2, 2, (b, l, 2)), rng.uniform(5, 10, (b, l, 1))], axis=-1
    ).astype(np.float32)
    poses = np.tile(np.array([1, 0, 0, 0, 0, 0, 0], np.float32), (b, w, 1))
    poses[:, :, 4] = 0.1 * np.arange(w)
    obs = np.zeros((b, l, w, 2), np.float32)
    for bi in range(b):
        for wi in range(w):
            p = lm_pos[bi] + np.array([poses[bi, wi, 4], 0, 0])
            obs[bi, :, wi, 0] = cam.focal * p[:, 0] / p[:, 2] + cam.cx
            obs[bi, :, wi, 1] = cam.focal * p[:, 1] / p[:, 2] + cam.cy
    batch = LandmarkMajorProblem(
        poses=poses,
        pose_valid=np.ones((b, w), bool),
        lm_pos=lm_pos + rng.normal(size=lm_pos.shape).astype(np.float32) * 0.01,
        lm_valid=np.ones((b, l), bool),
        obs_uv=obs,
        obs_valid=np.ones((b, l, w), bool),
        lm_prior=lm_pos,
        lm_prior_w=np.zeros((b, l), np.float32),
    )
    return cam, cfg, batch


def comm_bytes(w: int, lcap: int) -> dict:
    """Bytes all-reduced by one rank of the sharded ``lm_loop`` (f32), from
    the shapes: per damping attempt the ``[6W+1, 6W+1]`` Schur block plus the
    candidate cost and the landmark half of the predicted decrease; per
    accepted build the pose blocks ``[W, 6, 6]`` and ``[W, 6]``; once per
    solve the initial cost, and the all-gather of the ``[L, 3]`` landmarks."""
    n6 = 6 * w
    return {
        "per_attempt": ((n6 + 1) ** 2 + 2) * 4,
        "per_accepted_build": (w * 36 + w * 6) * 4,
        "per_solve_gather": lcap * 3 * 4,
    }


def _log(rank: int, msg: str) -> None:
    if rank == 0:
        print(msg, flush=True)


def _dryrun_rank(rank: int, world: int, device: str, shapes):
    """One rank of ``dryrun_multichip``; rank 0 returns the summary."""
    dev = _device(device, rank)
    summary = {"ranks": world, "device": device, "shapes": {}}

    # ---- 1. tiny dp x lm batch
    dp = 2 if world >= 4 and world % 2 == 0 else 1
    lm = world // dp
    cam, cfg, batch_np = _tiny_batch(dp, lm)
    mesh = make_mesh((dp, lm), ("dp", "lm"), device_type=dev.type)
    batch = _to_device(batch_np, dev)
    poses, lm_pos, c0, c1 = dp_sharded_bundle_adjust(batch, cam, cfg, mesh)
    poses, c0, c1 = poses.cpu().numpy(), c0.cpu().numpy(), c1.cpu().numpy()
    if not (np.all(np.isfinite(poses)) and np.all(c1 <= c0 + 1e-3)):
        raise RuntimeError(f"dp batch: costs {c0} -> {c1}")
    for b in range(dp):
        ref = lm_loop(LandmarkMajorProblem(*[x[b] for x in batch]), cam, cfg)
        err = float(np.abs(poses[b] - ref[0].cpu().numpy()).max())
        if err > POSE_TOL:
            raise RuntimeError(f"dp batch window {b}: poses differ from its own solve by {err}")
    _log(rank, f"dryrun tiny batch: mesh dp={dp} x lm={lm}, batch cost {c0.sum():.4f} -> "
               f"{c1.sum():.4f}, each window equals its single-device solve")
    summary["tiny_batch"] = {"dp": dp, "lm": lm, "cost0": float(c0.sum()),
                             "cost1": float(c1.sum())}

    # ---- 2. realistic shapes, sharded == single, iterations/s per shard count
    cam = CameraInfo(focal=718.856, cx=607.19, cy=185.22, baseline=0.537)
    shard_counts = [c for c in (1, 2, 4, 8) if c <= world]
    for tag, w, lcap in shapes:
        cfg = BackendConfig(window_size=w, landmark_capacity=lcap, max_lm_iters=ITERS,
                            lm_rel_tol=0.0)       # a fixed iteration count
        prob = _to_device(make_lm_problem(w, lcap, cam), dev)
        row = {"w": w, "l": lcap, "iters": ITERS, "shards": {}}
        if rank == 0:
            ref = lm_loop(prob, cam, cfg)
            _sync(dev)
            t = []
            for _ in range(3):
                t0 = time.perf_counter()
                lm_loop(prob, cam, cfg)
                _sync(dev)
                t.append(time.perf_counter() - t0)
            row["single_iters_per_s"] = ITERS / statistics.median(t)
            _log(rank, f"dryrun {tag}: single device {row['single_iters_per_s']:.1f} iters/s")
        for nsh in shard_counts:
            sub = make_mesh((nsh,), ("lm",), device_type=dev.type)
            if rank >= nsh:
                continue
            out = sharded_lm_solve(prob, cam, cfg, sub)
            _sync(dev)
            t = []
            for r in range(3):
                moved = prob._replace(lm_pos=prob.lm_pos + 1e-6 * (r + 1))
                t0 = time.perf_counter()
                sharded_lm_solve(moved, cam, cfg, sub)
                _sync(dev)
                t.append(time.perf_counter() - t0)
            if rank == 0:
                pose_err = float((out[0] - ref[0]).abs().max())
                lm_err = float((out[1] - ref[1]).abs().max())
                if pose_err > POSE_TOL or lm_err > LM_TOL:
                    raise RuntimeError(f"{tag} shards={nsh}: sharded != single "
                                       f"(poses {pose_err}, landmarks {lm_err})")
                rate = ITERS / statistics.median(t)
                row["shards"][nsh] = {"iters_per_s": rate, "pose_err": pose_err,
                                      "lm_err": lm_err}
                _log(rank, f"dryrun {tag}: shards={nsh} {rate:.1f} iters/s, max |sharded - "
                           f"single| poses {pose_err:.3g} landmarks {lm_err:.3g} (ok)")
        row["comm_bytes"] = comm_bytes(w, lcap)
        _log(rank, f"dryrun {tag}: all-reduce bytes per damping attempt "
                   f"{row['comm_bytes']['per_attempt']}, per accepted build "
                   f"+{row['comm_bytes']['per_accepted_build']}, landmark all-gather "
                   f"{row['comm_bytes']['per_solve_gather']} per solve")
        summary["shapes"][tag] = row
    return summary if rank == 0 else None


def dryrun_multichip(n_ranks: int, device: str = "cuda", shapes=SHAPES,
                     timeout: float = 600.0, store_dir=None) -> dict:
    """Run the dry run on ``n_ranks`` local ranks (see the module docstring);
    returns rank 0's summary. Raises if any check fails."""
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("dryrun_multichip: no CUDA device (pass device='cpu')")
    return spawn_ranks(_dryrun_rank, n_ranks, (device, tuple(shapes)),
                       store_dir=store_dir, timeout=timeout)[0]


def _solve_rank(rank, world, problem, cam, cfg, dp):
    if dp is None:
        mesh = make_mesh((world,), ("lm",), device_type="cpu")
        out, c0, c1 = sharded_bundle_adjust(_to_device(problem, "cpu"), cam, cfg, mesh)
        return _to_numpy((out.poses, out.lm_pos, c0, c1))
    mesh = make_mesh((dp, world // dp), ("dp", "lm"), device_type="cpu")
    return _to_numpy(dp_sharded_bundle_adjust(_to_device(problem, "cpu"), cam, cfg, mesh))


def solve_on_cpu_ranks(problem, cam, cfg, n_ranks: int, dp=None, store_dir=None,
                       timeout: float = 120.0):
    """One sharded solve on ``n_ranks`` local gloo ranks on the CPU; returns
    every rank's ``(poses, lm_pos, cost0, cost1)`` as numpy.

    With ``dp=None``, ``problem`` is a numpy ``WindowState`` and
    ``sharded_bundle_adjust`` shards it over all ranks; with ``dp``, it is a
    batched numpy ``LandmarkMajorProblem`` and ``dp_sharded_bundle_adjust``
    solves it on a ``dp x n_ranks/dp`` mesh."""
    return spawn_ranks(_solve_rank, n_ranks, (problem, cam, cfg, dp),
                       store_dir=store_dir, timeout=timeout)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m stereo_vo_tpu_torch.parallel.dryrun",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("n_ranks", type=int)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    dryrun_multichip(args.n_ranks, args.device)
    print(f"dryrun_multichip OK: {args.n_ranks} ranks on {args.device}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
