from stereo_vo_tpu_torch.eval.ate import absolute_trajectory_error, relative_pose_error, umeyama_align
from stereo_vo_tpu_torch.eval.trajectory import (
    load_kitti_trajectory,
    load_tum_trajectory,
    poses_to_positions,
    write_kitti_trajectory,
    write_tum_trajectory,
)
from stereo_vo_tpu_torch.eval.cv_twin import run_cv_twin
from stereo_vo_tpu_torch.eval.viz import draw_tracks, plot_trajectory

__all__ = [
    "absolute_trajectory_error",
    "relative_pose_error",
    "umeyama_align",
    "write_kitti_trajectory",
    "write_tum_trajectory",
    "load_kitti_trajectory",
    "load_tum_trajectory",
    "poses_to_positions",
    "draw_tracks",
    "plot_trajectory",
    "run_cv_twin",
]
