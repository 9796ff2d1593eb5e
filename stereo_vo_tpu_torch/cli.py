"""Command-line entry point of the PyTorch port (counterpart of
``stereo_vo_tpu/cli.py``, the ``roslaunch``/``rosrun`` replacement).

    svo-torch run --config kitti00 --kitti-root /data/kitti --sequence 00 --out out/
    svo-torch run --config kitti00 --synthetic 100 --out out/
    svo-torch eval --est out/trajectory_kitti.txt --gt poses/00.txt
    svo-torch configs

``run`` takes ``--device`` (default ``cuda``) and exits non-zero when that
device is not available: it never runs on the CPU unless asked to with
``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _device_error(device: str):
    """Why ``device`` cannot run the pipeline, or ``None`` when it can."""
    import torch

    try:
        dev = torch.device(device)
    except RuntimeError as e:
        return f"invalid --device {device!r}: {e}"
    if dev.type == "cuda" and not torch.cuda.is_available():
        return (f"--device {device}: no CUDA device is available "
                "(pass --device cpu to run on the CPU)")
    if dev.type not in ("cuda", "cpu"):
        return f"--device {device}: only cuda and cpu are supported"
    return None


def _cmd_run(args) -> int:
    err = _device_error(args.device)
    if err:
        print(f"error: {err}", file=sys.stderr)
        return 2
    if args.plot:
        from stereo_vo_tpu_torch.eval.viz import require_matplotlib

        try:
            require_matplotlib()
        except RuntimeError as e:
            print(f"error: --plot: {e}", file=sys.stderr)
            return 2
    from stereo_vo_tpu_torch.core.config import load_config
    from stereo_vo_tpu_torch.engine import run_vo

    cfg = load_config(args.config)

    if args.synthetic:
        from stereo_vo_tpu_torch.data.synthetic import SyntheticStereoSequence

        # KITTI-sized synthetic frames under the selected camera's intrinsics
        stream = SyntheticStereoSequence(
            cam=cfg.camera,
            n_frames=args.synthetic,
            shape=tuple(args.synthetic_shape),
            n_points=args.synthetic_points,
            seed=args.seed,
            speed=0.8,
            yaw_rate=0.003,
        )
    else:
        if not args.kitti_root:
            print("error: --kitti-root or --synthetic required", file=sys.stderr)
            return 2
        from stereo_vo_tpu_torch.data.kitti import kitti_replay

        stream = kitti_replay(
            args.kitti_root, args.sequence, rate_hz=cfg.frame_rate,
            max_frames=args.max_frames,
        )

    run = run_vo(
        stream,
        cfg,
        out_dir=args.out,
        max_frames=args.max_frames,
        checkpoint_every=args.checkpoint_every,
        resume_from=args.resume,
        chunk_size=args.chunk_size,
        save_track_images=args.save_track_images,
        save_world_points=args.save_world_points,
        progress=not args.quiet,
        device=args.device,
        trace=args.trace,
    )

    summary = {
        "frames": len(run.poses),
        "frames_per_sec": round(run.frames_per_sec, 3),
        "keyframes": sum(1 for s in run.frame_stats if s["is_keyframe"]),
        "ate": run.ate,
    }
    print(json.dumps(summary))

    if args.out and args.plot:
        from stereo_vo_tpu_torch.eval.trajectory import poses_to_positions
        from stereo_vo_tpu_torch.eval.viz import plot_trajectory

        plot_trajectory(
            poses_to_positions(run.poses),
            poses_to_positions(run.gt_poses) if run.gt_poses is not None else None,
            out_path=os.path.join(args.out, "trajectory.png"),
        )
    return 0


def _cmd_eval(args) -> int:
    from stereo_vo_tpu_torch.eval.ate import absolute_trajectory_error, relative_pose_error
    from stereo_vo_tpu_torch.eval.trajectory import load_kitti_trajectory, load_tum_trajectory

    def load(path):
        with open(path) as f:
            probe = f.readline().split()
        return load_kitti_trajectory(path) if len(probe) == 12 else load_tum_trajectory(path)

    est = load(args.est)
    gt = load(args.gt)
    out = {
        "ate": absolute_trajectory_error(est, gt, align=not args.no_align),
        "rpe_1": relative_pose_error(est, gt, delta=1),
    }
    print(json.dumps(out))
    return 0


def _cmd_configs(_args) -> int:
    from stereo_vo_tpu_torch.core.config import available_configs

    print("\n".join(sorted(available_configs())))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="svo-torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("run", help="replay a sequence through the VO pipeline")
    pr.add_argument("--config", required=True, help="camera config name or path")
    pr.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; cpu only when asked)")
    pr.add_argument("--kitti-root", default=None)
    pr.add_argument("--sequence", default="00")
    pr.add_argument("--synthetic", type=int, default=0, metavar="N",
                    help="use an N-frame synthetic world instead of a dataset")
    pr.add_argument("--synthetic-shape", type=int, nargs=2, default=(376, 1241))
    pr.add_argument("--synthetic-points", type=int, default=4000)
    pr.add_argument("--seed", type=int, default=0)
    pr.add_argument("--out", default=None)
    pr.add_argument("--max-frames", type=int, default=None)
    pr.add_argument("--checkpoint-every", type=int, default=0)
    pr.add_argument("--chunk-size", type=int, default=0,
                    help="offline fast path: frames per replayed chunk (0 = streaming)")
    pr.add_argument("--save-track-images", type=int, default=0, metavar="N",
                    help="write a feature-track debug image every N frames")
    pr.add_argument("--save-world-points", action="store_true",
                    help="dump the live landmark table per keyframe "
                         "(the reference's /vo/features debug output)")
    pr.add_argument("--resume", default=None, help="checkpoint file to resume from")
    pr.add_argument("--plot", action="store_true", help="write trajectory.png (needs matplotlib)")
    pr.add_argument("--quiet", action="store_true")
    pr.add_argument("--trace", action="store_true",
                    help="record the engine's spans; with --out, write them to spans.json "
                         "(Chrome trace format)")
    pr.set_defaults(fn=_cmd_run)

    pe = sub.add_parser("eval", help="ATE/RPE between two trajectory files")
    pe.add_argument("--est", required=True)
    pe.add_argument("--gt", required=True)
    pe.add_argument("--no-align", action="store_true")
    pe.set_defaults(fn=_cmd_eval)

    pc = sub.add_parser("configs", help="list bundled camera configs")
    pc.set_defaults(fn=_cmd_configs)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
