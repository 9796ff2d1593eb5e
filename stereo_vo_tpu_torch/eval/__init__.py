from stereo_vo_tpu_torch.eval.ate import absolute_trajectory_error, relative_pose_error, umeyama_align
from stereo_vo_tpu_torch.eval.trajectory import (
    load_tum_trajectory,
    poses_to_positions,
    write_kitti_trajectory,
    write_tum_trajectory,
)

__all__ = [
    "absolute_trajectory_error",
    "relative_pose_error",
    "umeyama_align",
    "write_kitti_trajectory",
    "write_tum_trajectory",
    "load_tum_trajectory",
    "poses_to_positions",
]
