from stereo_vo_tpu_torch.frontend.detect import dedup_new_features, detect_features
from stereo_vo_tpu_torch.frontend.pnp import pnp_ransac
from stereo_vo_tpu_torch.frontend.track import TrackerState, track_step, tracker_init
from stereo_vo_tpu_torch.frontend.triangulate import triangulate_from_disparities

__all__ = [
    "triangulate_from_disparities",
    "pnp_ransac",
    "TrackerState",
    "tracker_init",
    "track_step",
    "detect_features",
    "dedup_new_features",
]
